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

Which kernel runs is fixed by ``bits`` and the table size alone
(``plan``): the fields kernel, which decodes each corpus field once for
a block of QB queries held in registers, when bits is 1, 2 or 4, the
block's 8 tables take at most 128 KB of shared memory (8 * F * P * 4
bytes: k = 256 at 4 bits is the largest) and they fit beside its two
corpus tiles (2 * 256 * (max(W, QB) | 1) * 4 bytes) in the 227 KB a
block may hold; else the generic kernel (bits 8 and 16, larger tables),
one query a warp, 8 a block. Either raises if it does not launch: one
never stands in for the other.

Launch knobs, none of which changes a bit: ``n_ranges`` (S, the corpus
ranges a query block is split over: the partial lists merge in range
order under the strictly-beats rule) and ``block_q`` (QB, the fields
kernel's queries a block, 16 or 8: every score is the same chain of
adds). Their defaults: QB the first of ``BLOCK_Q`` whose layout fits;
S the smallest that makes the grid's blocks the most nearly whole
waves of the blocks the card holds at once (``whole_waves``), for the
fields kernel, and ``packed_collision.n_ranges`` for the generic one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.packed_collision import (check_valid, check_words,
                                                  resolve_ranges)
from repro_torch.kernels.packed_lut import check_tables

__all__ = ["packed_lut_topk_cuda", "packed_lut_topk_masked_cuda", "plan",
           "fields_layout", "whole_waves", "BLOCK_Q", "launches",
           "masked_launches"]

FIELD_BITS = (1, 2, 4)
FIELD_THREADS = 256             # threads a block = corpus rows a tile
FIELD_TABLES_MAX = 128 * 1024   # bytes of a block's QB tables
SMEM_BLOCK_MAX = 232448         # 227 KB: a block's most shared memory
SMEM_LIST_MAX = 2048            # longer lists live in device memory
GENERIC_Q = 8                   # the generic kernel's queries a block
BLOCK_Q = (16, 8)               # the fields kernel's QB, in preference

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0          # packed_lut_topk
masked_launches = 0   # packed_lut_topk_masked

_P = ctypes.c_void_p
_I = ctypes.c_int
_occupancy: dict = {}


def fields_layout(w: int, bits: int, top_k: int, block_q: int):
    """The fields kernel's dynamic shared memory at QB = ``block_q``:
    (bytes, lists in shared memory), or None where it takes the generic
    kernel. The tables [F][QB/4][P][4] float32, two corpus tiles
    [256][max(W, QB) | 1] words, and the QB lists' scores and ids when
    top_k <= 2048 and they fit too."""
    if bits not in FIELD_BITS:
        return None
    tab = block_q * (w * (32 // bits) << bits) * 4
    base = tab + 2 * FIELD_THREADS * (max(w, block_q) | 1) * 4
    if tab > FIELD_TABLES_MAX or base > SMEM_BLOCK_MAX:
        return None
    lists = 2 * block_q * top_k * 4
    in_smem = top_k <= SMEM_LIST_MAX and base + lists <= SMEM_BLOCK_MAX
    return base + (lists if in_smem else 0), in_smem


def whole_waves(q_blocks: int, n: int, resident: int,
                rows: int = FIELD_THREADS) -> int:
    """S for ``q_blocks`` query blocks over ``n`` rows when the card holds
    ``resident`` blocks at once: the smallest S (at least ``rows``, a
    tile of rows, a range; at most 4 waves' worth) whose q_blocks * S
    blocks fill their last wave the most."""
    cap = max(1, -(-n // rows))
    top = min(cap, 4 * -(-resident // q_blocks))
    best, best_fill = 1, 0.0
    for s in range(1, top + 1):
        blocks = q_blocks * s
        fill = blocks / (-(-blocks // resident) * resident)
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def _fields_occupancy(code: int, bits: int, qb: int, smem: int) -> int:
    from repro_torch.kernels import _build
    key = (code, bits, qb, smem)
    if key not in _occupancy:
        fn = _build.function("lut_topk", "lut_topk_fields_occupancy",
                             [_I, _I, _I, _I, ctypes.POINTER(_I)])
        blocks = _I(0)
        err = fn(code, bits, qb, smem, ctypes.byref(blocks))
        if err or blocks.value < 1:
            raise RuntimeError(f"lut_topk fields kernel (bits {bits}, QB "
                               f"{qb}, {smem} B) does not fit an SM: CUDA "
                               f"error {err}")
        _occupancy[key] = blocks.value
    return _occupancy[key]


def plan(tables_dtype, nq: int, n: int, w: int, bits: int, top_k: int,
         block_q=None, n_ranges=None, device=None) -> dict:
    """The launch a call makes: kernel ("fields" or "generic"), block_q,
    n_ranges, grid, smem and lists_in_smem (fields), blocks_per_sm and
    waves (fields: the grid's blocks over the card's resident blocks).
    Raises ``ValueError`` for a ``block_q`` the kernel cannot take."""
    code = 0 if tables_dtype == torch.float32 else 1
    if block_q is not None and int(block_q) not in BLOCK_Q:
        raise ValueError(f"block_q must be one of {BLOCK_Q}, got {block_q}")
    if fields_layout(w, bits, top_k, min(BLOCK_Q)) is None:
        if block_q is not None and int(block_q) != GENERIC_Q:
            raise ValueError(f"the generic kernel takes {GENERIC_Q} queries "
                             f"a block, not {block_q}")
        s = resolve_ranges(n_ranges, nq, n, device)
        return dict(kernel="generic", block_q=GENERIC_Q, n_ranges=s,
                    grid=(-(-nq // GENERIC_Q), s), smem=None,
                    lists_in_smem=None, blocks_per_sm=None, waves=None)
    qb = next(q for q in BLOCK_Q if fields_layout(w, bits, top_k, q)) \
        if block_q is None else int(block_q)
    layout = fields_layout(w, bits, top_k, qb)
    if layout is None:
        raise ValueError(f"block_q {qb} does not fit shared memory at "
                         f"w={w}, bits={bits}, top_k={top_k}")
    smem, in_smem = layout
    per_sm = _fields_occupancy(code, bits, qb, smem)
    resident = per_sm * torch.cuda.get_device_properties(
        device).multi_processor_count
    q_blocks = -(-nq // qb)
    s = whole_waves(q_blocks, n, resident) if n_ranges is None else \
        resolve_ranges(n_ranges, nq, n, device)
    return dict(kernel="fields", block_q=qb, n_ranges=s, grid=(q_blocks, s),
                smem=smem, lists_in_smem=in_smem, blocks_per_sm=per_sm,
                waves=q_blocks * s / resident)


def _lut_topk(tables, words_db, valid_words, bits: int, top_k: int,
              n_ranges, block_q):
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
    p = plan(tables.dtype, nq, n, w, bits, top_k, block_q, n_ranges, dev)
    s = p["n_ranges"]
    fields = p["kernel"] == "fields"
    part_s = torch.empty((s, nq, top_k), dtype=torch.float32, device=dev)
    part_i = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    scores = torch.empty((nq, top_k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    tail = [part_s.data_ptr(), part_i.data_ptr(), scores.data_ptr(),
            ids.data_ptr(), nq, n, w, bits, top_k, s,
            p["block_q"] if fields else 0, p["smem"] if fields else 0,
            int(bool(p["lists_in_smem"])),
            torch.cuda.current_stream(dev).cuda_stream]
    types = [_P, _P, _P, _P] + [_I] * 9 + [_P]
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
        raise RuntimeError(f"packed_lut_topk {p['kernel']} kernel launch "
                           f"failed: CUDA error {err}")
    if valid_words is None:
        launches += 1
    else:
        masked_launches += 1
    return scores, ids


def packed_lut_topk_cuda(tables: torch.Tensor, words_db: torch.Tensor,
                         bits: int, top_k: int, n_ranges=None, block_q=None):
    """Launches the partial LUT top-k kernel over S corpus ranges (the
    fields or the generic kernel, by ``plan``) and the merge kernel ->
    (scores float32, ids int32) [Q, top_k]."""
    return _lut_topk(tables, words_db, None, bits, top_k, n_ranges, block_q)


def packed_lut_topk_masked_cuda(tables: torch.Tensor, words_db: torch.Tensor,
                                valid_words: torch.Tensor, bits: int,
                                top_k: int, n_ranges=None, block_q=None):
    """``packed_lut_topk_cuda`` over the rows whose bit is set in
    ``valid_words`` int32 [ceil(N/32)]; slots past the live count are
    (-inf, -1)."""
    return _lut_topk(tables, words_db, valid_words, bits, top_k, n_ranges,
                     block_q)
