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
  [Q, N], by the kernel ``counts_plan`` picks from the shape alone:
  ``packed_counts_tc`` (the same one-hot product on the int8 tensor
  cores, its counts staged in shared memory and written 256 bytes a
  query and tile by TMA stores, or by 4-byte stores where N is not a
  multiple of 4) for 1- and 2-bit codes whose one-hot queries fit
  (``counts_layout``), else the popcount kernel.
  ``counts_tc_launches`` counts the tensor kernel's launches.

The top-k kernels' count sweep is chosen by ``plan``, from the shape
alone and before the launch: the int8 tensor-core kernel
(``csrc/topk_tc.cuh``: collision counts as a product of one-hot codes)
for 1- and 2-bit codes whose QB one-hot queries (QB * 64 * W bytes) fit
shared memory beside its ring and staged counts (``tc_layout``), at QB =
128 when there are more than 64 queries and its lists fit, else 64; the
popcount kernel (``packed_topk_partial``) for 4-, 8- and 16-bit codes and
wider words. Either raises if it does not launch: one never stands in
for the other. ``tc_launches`` counts the tensor-core kernel's launches,
by whichever wrapper (here or ``fused_scored``).

Launch knobs, none of which changes a bit: ``n_ranges`` (S, the corpus
ranges of the top-k kernels; their partial lists merge in range order
under the strictly-beats rule) and ``block_q`` (queries a block of the
count kernels: any positive number for the popcount kernel; the tensor
kernel takes QB = 128 at 128 or more where that fits, else 64). S
defaults to ``n_ranges`` for the popcount kernel and, for the
tensor-core kernel, to twice the block rows (two ranges a block)
that make the grid the most nearly whole waves of the blocks the card
holds at once (``lut_topk.whole_waves``). Any top_k is answered: lists
longer than 2048 entries, or too long for shared memory beside the
tensor-core kernel's operands, live in device memory
(``csrc/topk_common.cuh``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["packed_topk_cuda", "packed_topk_masked_cuda",
           "packed_topk_partial_cuda", "merge_ranges_cuda",
           "packed_collision_counts_cuda", "n_ranges", "resolve_ranges",
           "plan", "tc_layout", "counts_plan", "counts_layout",
           "check_words", "check_valid", "COUNT_BLOCK_Q", "launches",
           "masked_launches", "counts_launches", "counts_tc_launches",
           "tc_launches"]

WARPS = 8          # queries per block (csrc/packed_topk.cu)
COUNT_BLOCK_Q = 32   # default queries a block of csrc/packed_counts.cu
# the tensor-core sweep (csrc/topk_tc.cuh)
TC_BITS = (1, 2)
TC_BLOCK_Q = (128, 64)       # its QB, in preference
TC_WG = 2                    # warpgroups a block, a corpus range each
TC_ROWS = 64                 # corpus rows a tile
TC_STAGES = 2                # corpus tiles in a warpgroup's ring
TC_LD = TC_ROWS + 8          # int16 counts a query when staged
SMEM_BLOCK_MAX = 232448      # 227 KB: a block's most shared memory
SMEM_LIST_MAX = 2048         # longer lists live in device memory
# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0          # packed_topk
masked_launches = 0   # packed_topk_masked
counts_launches = 0   # packed_collision_counts, either kernel
counts_tc_launches = 0   # its tensor-core kernel
tc_launches = 0       # the tensor-core sweep, under any of the four top-k ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_occupancy: dict = {}   # (kernel, bits, QB, ...) -> blocks an SM


def n_ranges(nq: int, n: int, sms: int) -> int:
    """Corpus ranges S: about 4 blocks per SM over the query tiles, and
    no range under 2048 rows."""
    tiles = -(-nq // WARPS)
    return max(1, min(-(-4 * sms // tiles), n // 2048))


def resolve_ranges(s, nq: int, n: int, device, sms=None) -> int:
    """S for a call: ``n_ranges`` of the card (or of ``sms`` SMs) when
    ``s`` is None, else ``s`` clamped to [1, n]."""
    if s is None:
        if sms is None:
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
        return n_ranges(nq, n, sms)
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


def tc_layout(w: int, bits: int, top_k: int, block_q: int):
    """The tensor-core sweep's dynamic shared memory at QB = ``block_q``:
    (bytes, lists in shared memory), or None where it does not fit (or
    ``bits`` is not 1 or 2). The one-hot queries [4 ceil(W/8)][QB][128]
    u8 (K in whole pairs of 4-word batches), the two warpgroups' rings
    [2][64][W | 1] words, staged counts [QB][72] int16, thresholds [QB]
    int32 and hit words [4][QB/32], 1024 bytes of alignment, and the
    lists [2][2][QB][top_k] int32 when top_k <= 2048 and they fit too."""
    if bits not in TC_BITS:
        return None
    onehot = 4 * -(-w // 8) * block_q * 128
    ring = TC_WG * TC_STAGES * TC_ROWS * (w | 1) * 4
    staged = TC_WG * (block_q * (TC_LD * 2 + 4) + block_q // 2)
    base = 1024 + onehot + ring + staged
    if base > SMEM_BLOCK_MAX:
        return None
    lists = TC_WG * 2 * block_q * top_k * 4
    in_smem = top_k <= SMEM_LIST_MAX and base + lists <= SMEM_BLOCK_MAX
    return base + (lists if in_smem else 0), in_smem


def _tc_occupancy(bits: int, qb: int, smem: int) -> int:
    from repro_torch.kernels import _build
    key = ("topk", bits, qb, smem)
    if key not in _occupancy:
        fn = _build.function("packed_topk", "packed_topk_tc_occupancy",
                             [_I, _I, _I, ctypes.POINTER(_I)])
        blocks = _I(0)
        err = fn(bits, qb, smem, ctypes.byref(blocks))
        if err or blocks.value < 1:
            raise RuntimeError(f"packed_topk tensor-core kernel (bits {bits}, "
                               f"QB {qb}, {smem} B) does not fit an SM: CUDA "
                               f"error {err}")
        _occupancy[key] = blocks.value
    return _occupancy[key]


def plan(nq: int, n: int, w: int, bits: int, top_k: int, n_ranges=None,
         device=None, sms=None, blocks_per_sm=None) -> dict:
    """The count sweep a top-k call launches: kernel ("tensor" or
    "popcount"), block_q, n_ranges, grid, smem and lists_in_smem
    (tensor), blocks_per_sm and waves (tensor: the grid's blocks over the
    card's resident blocks). ``sms`` and ``blocks_per_sm`` stand in for
    the card's (the tests' way to plan without one)."""
    if tc_layout(w, bits, top_k, TC_BLOCK_Q[-1]) is None:
        s = resolve_ranges(n_ranges, nq, n, device, sms)
        return dict(kernel="popcount", block_q=WARPS, n_ranges=s,
                    grid=(-(-nq // WARPS), s), smem=None,
                    lists_in_smem=None, blocks_per_sm=None, waves=None)
    qb = _tc_block_q(nq, w, bits, top_k)
    smem, in_smem = tc_layout(w, bits, top_k, qb)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if blocks_per_sm is None:
        blocks_per_sm = _tc_occupancy(bits, qb, smem)
    resident = blocks_per_sm * sms
    q_blocks = -(-nq // qb)
    if n_ranges is None:
        from repro_torch.kernels.lut_topk import whole_waves
        s = min(TC_WG * whole_waves(q_blocks, n, resident,
                                    rows=TC_WG * TC_ROWS), max(n, 1))
    else:
        s = resolve_ranges(n_ranges, nq, n, device, sms)
    grid = (q_blocks, -(-s // TC_WG))
    return dict(kernel="tensor", block_q=qb, n_ranges=s, grid=grid,
                smem=smem, lists_in_smem=in_smem,
                blocks_per_sm=blocks_per_sm,
                waves=grid[0] * grid[1] / resident)


def _tc_block_q(nq: int, w: int, bits: int, top_k: int) -> int:
    """The tensor-core sweep's QB: 128 when there are more than 64
    queries and its lists fit shared memory beside its operands, else 64
    (lists in shared memory where they fit)."""
    if nq > 64:
        layout = tc_layout(w, bits, top_k, 128)
        if layout is not None and layout[1]:
            return 128
    return 64


def _sweep_args(p: dict) -> list:
    """The C launch's (qb, smem, in_smem) of a plan: qb 0 for the
    popcount kernel."""
    if p["kernel"] != "tensor":
        return [0, 0, 0]
    return [p["block_q"], p["smem"], int(p["lists_in_smem"])]


def _check_topk(words_q, words_db, valid_words, bits: int, top_k: int):
    nq, n, w = check_words(words_q, words_db, bits)
    if valid_words is not None:
        check_valid(valid_words, words_db)
    if top_k < 1:
        raise ValueError(f"top_k must be at least 1, got {top_k}")
    return nq, n, w


def _topk(words_q, words_db, valid_words, bits: int, k: int, top_k: int,
          s):
    """The count sweep over S corpus ranges (``plan``), then the merge:
    the unmasked entry point when ``valid_words`` is None, else the masked
    one."""
    global launches, masked_launches, tc_launches
    from repro_torch.kernels import _build
    nq, n, w = _check_topk(words_q, words_db, valid_words, bits, top_k)
    dev = words_q.device
    if nq == 0 or n == 0:
        empty = torch.full((nq, top_k), -1, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    vals = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    ids = torch.empty((nq, top_k), dtype=torch.int32, device=dev)
    p = plan(nq, n, w, bits, top_k, s, dev)
    s = p["n_ranges"]
    part_v = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    part_i = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    tail = [part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), nq, n, w, bits, k, top_k, s, *_sweep_args(p),
            torch.cuda.current_stream(dev).cuda_stream]
    types = [_P, _P, _P, _P] + [_I] * 10 + [_P]
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
        raise RuntimeError(f"packed_topk kernel launch failed ({p['kernel']} "
                           f"sweep): CUDA error {err}")
    if valid_words is None:
        launches += 1
    else:
        masked_launches += 1
    if p["kernel"] == "tensor":
        tc_launches += 1
    return vals, ids


def packed_topk_partial_cuda(words_q: torch.Tensor, words_db: torch.Tensor,
                             valid_words, bits: int, k: int, top_k: int,
                             n_ranges=None):
    """The count sweep alone, the kernel ``plan`` picks: per query, the
    stable top_k of each of S contiguous corpus ranges (of ceil(N/S) rows)
    -> (counts, ids) int32 [S, Q, top_k], (-1, -1) past a range's live
    rows. ``valid_words`` may be None."""
    global tc_launches
    from repro_torch.kernels import _build
    nq, n, w = _check_topk(words_q, words_db, valid_words, bits, top_k)
    dev = words_q.device
    if nq == 0 or n == 0:
        raise ValueError("the count sweep needs queries and rows")
    p = plan(nq, n, w, bits, top_k, n_ranges, dev)
    s = p["n_ranges"]
    part_v = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    part_i = torch.empty((s, nq, top_k), dtype=torch.int32, device=dev)
    fn = _build.function("packed_topk", "packed_topk_partial_launch",
                         [_P, _P, _P, _P, _P] + [_I] * 10 + [_P])
    err = fn(words_q.data_ptr(), words_db.data_ptr(),
             None if valid_words is None else valid_words.data_ptr(),
             part_v.data_ptr(), part_i.data_ptr(), nq, n, w, bits, k, top_k,
             s, *_sweep_args(p), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"packed_topk {p['kernel']} sweep launch failed: "
                           f"CUDA error {err}")
    if p["kernel"] == "tensor":
        tc_launches += 1
    return part_v, part_i


def merge_ranges_cuda(part_vals: torch.Tensor, part_ids: torch.Tensor):
    """The merge kernel alone: partial lists int32 [S, Q, top_k] -> the
    stable top_k of their union, taken in range order, [Q, top_k]."""
    for name, t in (("part_vals", part_vals), ("part_ids", part_ids)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 3 \
                or not t.is_contiguous() or t.shape != part_vals.shape:
            raise ValueError(f"{name} must be a contiguous int32 CUDA tensor "
                             f"[S, Q, top_k] like part_vals, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    from repro_torch.kernels import _build
    s, nq, top_k = part_vals.shape
    vals = torch.empty((nq, top_k), dtype=torch.int32, device=part_vals.device)
    ids = torch.empty_like(vals)
    fn = _build.function("packed_topk", "packed_topk_merge_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _P])
    err = fn(part_vals.data_ptr(), part_ids.data_ptr(), vals.data_ptr(),
             ids.data_ptr(), nq, top_k, s,
             torch.cuda.current_stream(part_vals.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_topk merge launch failed: CUDA error {err}")
    return vals, ids


def packed_topk_cuda(words_q: torch.Tensor, words_db: torch.Tensor,
                     bits: int, k: int, top_k: int, n_ranges=None):
    """Launches the count sweep over S corpus ranges (``plan``) and the
    merge kernel -> (counts, ids) int32 [Q, top_k]."""
    return _topk(words_q, words_db, None, bits, k, top_k, n_ranges)


def packed_topk_masked_cuda(words_q: torch.Tensor, words_db: torch.Tensor,
                            valid_words: torch.Tensor, bits: int, k: int,
                            top_k: int, n_ranges=None):
    """``packed_topk_cuda`` over the rows whose bit is set in
    ``valid_words`` int32 [ceil(N/32)] -> (counts, ids) int32 [Q, top_k];
    slots past the live count are (-1, -1)."""
    return _topk(words_q, words_db, valid_words, bits, k, top_k, n_ranges)


def counts_layout(w: int, bits: int, block_q: int):
    """The tensor-core count kernel's dynamic shared memory at QB =
    ``block_q`` (bytes), or None where it does not fit (or ``bits`` is
    not 1 or 2): the one-hot queries [4 ceil(W/8)][QB][128] u8, the two
    warpgroups' staged counts [2][QB][64] int32 and rings [2][64][W | 1]
    words, and 1024 bytes of alignment."""
    if bits not in TC_BITS:
        return None
    onehot = 4 * -(-w // 8) * block_q * 128
    staged = TC_WG * block_q * TC_ROWS * 4
    ring = TC_WG * TC_STAGES * TC_ROWS * (w | 1) * 4
    total = 1024 + onehot + staged + ring
    return total if total <= SMEM_BLOCK_MAX else None


def _counts_occupancy_of(bits: int, qb: int, tma: bool, smem: int) -> int:
    from repro_torch.kernels import _build
    key = ("counts", bits, qb, tma, smem)
    if key not in _occupancy:
        fn = _build.function("packed_counts", "packed_counts_tc_occupancy",
                             [_I, _I, _I, _I, ctypes.POINTER(_I)])
        blocks = _I(0)
        err = fn(bits, qb, int(tma), smem, ctypes.byref(blocks))
        if err or blocks.value < 1:
            raise RuntimeError(f"packed_counts tensor-core kernel (bits "
                               f"{bits}, QB {qb}, {smem} B) does not fit an "
                               f"SM: CUDA error {err}")
        _occupancy[key] = blocks.value
    return _occupancy[key]


def counts_plan(nq: int, n: int, w: int, bits: int, block_q=None,
                device=None, sms=None, blocks_per_sm=None) -> dict:
    """The kernel an all-pairs count call launches, by shape alone:
    kernel ("tensor" for 1- and 2-bit codes whose one-hot queries fit at
    QB = 64, else "popcount"), block_q (QB, or the popcount kernel's
    queries a block), grid, smem, store (tensor: "tma" where N is a
    multiple of 4, TMA's 16-byte row stride, else "4-byte") and
    blocks_per_sm (tensor: the grid is the card's resident blocks over
    the query blocks, at most one warpgroup a 64-row tile). ``block_q``
    None takes the defaults: QB 128 for more than 64 queries where it
    fits, else 64; COUNT_BLOCK_Q for the popcount kernel. ``sms`` and
    ``blocks_per_sm`` stand in for the card's. Plans are cached by shape,
    the card's SMs and the limits."""
    if block_q is not None and block_q < 1:
        raise ValueError(f"block_q must be positive, got {block_q}")
    if counts_layout(w, bits, TC_BLOCK_Q[-1]) is not None and sms is None:
        from repro_torch.kernels.packed_linear import _sm_count
        sms = _sm_count(device)
    return dict(_counts_plan(nq, n, w, bits, block_q, sms, blocks_per_sm,
                             (SMEM_BLOCK_MAX, COUNT_BLOCK_Q)))


@functools.lru_cache(maxsize=256)
def _counts_plan(nq: int, n: int, w: int, bits: int, block_q, sms,
                 blocks_per_sm, limits: tuple) -> dict:
    # limits: SMEM_BLOCK_MAX and COUNT_BLOCK_Q at the call, in the key
    # alone (the helpers read the module's)
    if counts_layout(w, bits, TC_BLOCK_Q[-1]) is None:
        qt = COUNT_BLOCK_Q if block_q is None else int(block_q)
        if -(-nq // qt) > 65535:
            raise ValueError(f"at most 65535 blocks of block_q {qt} may "
                             f"cover the queries, got {nq}")
        return dict(kernel="popcount", block_q=qt,
                    grid=(-(-n // 128), -(-nq // qt)), smem=qt * w * 4,
                    store=None, blocks_per_sm=None)
    want = block_q if block_q is not None else (128 if nq > 64 else 64)
    qb = 128 if want >= 128 and counts_layout(w, bits, 128) is not None \
        else 64
    smem = counts_layout(w, bits, qb)
    store = "tma" if n % 4 == 0 else "4-byte"
    if blocks_per_sm is None:
        blocks_per_sm = _counts_occupancy_of(bits, qb, store == "tma", smem)
    q_blocks = -(-nq // qb)
    tiles = -(-n // TC_ROWS)
    cols = max(1, min(blocks_per_sm * sms // max(q_blocks, 1),
                      -(-tiles // TC_WG)))
    return dict(kernel="tensor", block_q=qb, grid=(q_blocks, cols),
                smem=smem, store=store, blocks_per_sm=blocks_per_sm)


def packed_collision_counts_cuda(words_q: torch.Tensor,
                                 words_db: torch.Tensor, bits: int,
                                 k: int, block_q=None) -> torch.Tensor:
    """Launches the all-pairs count kernel ``counts_plan`` picks ->
    int32 counts [Q, N]."""
    global counts_launches, counts_tc_launches
    from repro_torch.kernels import _build
    nq, n, w = check_words(words_q, words_db, bits)
    if block_q is not None and block_q < 1:
        raise ValueError(f"block_q must be positive, got {block_q}")
    out = torch.empty((nq, n), dtype=torch.int32, device=words_q.device)
    if nq == 0 or n == 0:
        return out
    p = counts_plan(nq, n, w, bits, block_q, words_q.device)
    stream = torch.cuda.current_stream(words_q.device).cuda_stream
    if p["kernel"] == "tensor":
        fn = _build.function("packed_counts", "packed_counts_tc_launch",
                             [_P, _P, _P] + [_I] * 9 + [_P])
        err = fn(words_q.data_ptr(), words_db.data_ptr(), out.data_ptr(), nq,
                 n, w, bits, k, p["block_q"], p["grid"][1], p["smem"],
                 int(p["store"] == "tma"), stream)
    else:
        fn = _build.function("packed_counts", "packed_counts_launch",
                             [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
        err = fn(words_q.data_ptr(), words_db.data_ptr(), out.data_ptr(), nq,
                 n, w, bits, k, p["block_q"], stream)
    if err:
        raise RuntimeError(f"packed_collision_counts {p['kernel']} kernel "
                           f"launch failed: CUDA error {err}")
    counts_launches += 1
    if p["kernel"] == "tensor":
        counts_tc_launches += 1
    return out
