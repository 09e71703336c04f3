"""Wrappers of the packed-linear CUDA kernels (``csrc/packed_linear.cu``).

Counterparts of ``repro/kernels/packed_linear.py``:

* ``packed_linear_fwd_cuda`` (``packed_linear_fwd_pallas`` and, with
  ``valid_words``, ``packed_linear_fwd_masked_pallas``): float32 class
  tables [C, F*P] x int32 words [N, W] -> float32 margins [C, N], dead
  rows 0.0; ``fwd_plan`` picks its form (class tables in shared memory,
  or read from device memory) and grid by shape before the launch;
* ``packed_linear_bwd_cuda`` (``packed_linear_bwd_pallas`` and, with
  ``valid_words``, ``packed_linear_bwd_masked_pallas``): float32 margin
  gradients [C, N] x words -> float32 table gradients [C, F*P], in the
  sum order of ``ref.packed_linear_bwd_ref`` at the same ``block_n``;
  ``bwd_plan`` picks its partial kernel by shape before the launch, and
  ``bwd_partials_cuda`` / ``bwd_fold_cuda`` run its two halves apart.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.packed_collision import check_valid

__all__ = ["packed_linear_fwd_cuda", "packed_linear_bwd_cuda",
           "bwd_partials_cuda", "bwd_fold_cuda", "fwd_class_tile",
           "fwd_plan", "FWD_THREADS", "FWD_BLOCKS_MAX",
           "bwd_group_chunks", "bwd_classes_per_thread",
           "bwd_fields_per_thread", "bwd_plan", "SMEM_TABLE_MAX",
           "PART_BYTES_MAX", "SLOT_BYTES", "launches", "masked_launches",
           "bwd_launches", "bwd_masked_launches"]

SMEM_TABLE_MAX = 96 * 1024     # shared memory for a block's class tables
FWD_THREADS = 256              # rows a forward tile: one thread a row
FWD_BLOCKS_MAX = 1 << 20       # the most forward blocks a class tile
PART_BYTES_MAX = 256 << 20     # the backward's partials, a group of chunks
SLOT_BYTES = 12 * 1024         # a ring slot of the tiled partial kernel
SMEM_BLOCK_MAX = 232448        # 227 KB: a block's most shared memory
TILED_BITS = (1, 2, 4)         # fields the tiled partial kernel takes
PART_THREADS = 256             # its most threads a block
FOLD_SLAB = 8                  # entries a fold block adds
# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0              # packed_linear_fwd
masked_launches = 0       # packed_linear_fwd_masked
bwd_launches = 0          # packed_linear_bwd
bwd_masked_launches = 0   # packed_linear_bwd_masked

_P = ctypes.c_void_p
_I = ctypes.c_int
_occupancy: dict = {}
_sms: dict = {}


def fwd_class_tile(fp: int) -> int:
    """Classes a forward block keeps in shared memory for tables of
    ``fp`` float32 entries a class; 0 when one class does not fit (the
    tables are then read from device memory)."""
    return SMEM_TABLE_MAX // (4 * fp)


def _fwd_occupancy(bits: int, masked: bool, smem: int) -> int:
    from repro_torch.kernels import _build
    key = ("fwd", bits, masked, smem)
    if key not in _occupancy:
        fn = _build.function("packed_linear", "packed_linear_fwd_occupancy",
                             [_I, _I, _I, ctypes.POINTER(_I)])
        blocks = _I(0)
        err = fn(bits, int(masked), smem, ctypes.byref(blocks))
        if err or blocks.value < 1:
            raise RuntimeError(f"packed_linear_fwd kernel (bits {bits}, "
                               f"{smem} B) does not fit an SM: CUDA error "
                               f"{err}")
        _occupancy[key] = blocks.value
    return _occupancy[key]


def fwd_plan(n: int, w: int, bits: int, c: int, masked: bool = False,
             device=None, sms=None, blocks_per_sm=None) -> dict:
    """How the forward runs, by shape alone, before any launch.

    ``form``: "smem" (1-, 2-, 4- and 8-bit fields whose tables fit
    ``SMEM_TABLE_MAX`` a class: a block copies a class tile's tables into
    shared memory once, then walks row tiles of ``FWD_THREADS`` rows, one
    thread a row) or "mem" (one class does not fit, or 16-bit fields:
    tables read from device memory, a block a row tile). Both: threads
    (the rows of a tile), tiles, class_tile (0 for "mem"), smem and grid;
    "smem" also blocks_per_sm and tiles_per_block: the card's resident
    blocks, at most ``FWD_BLOCKS_MAX`` a class tile, spread over the class
    tiles, and none without a tile. ``sms`` and ``blocks_per_sm`` stand in
    for the card's (the tests' way to plan without one). Plans are cached
    by shape, the card's SMs and the limits (which the tests shrink)."""
    if sms is None:
        sms = _sm_count(device)
    return dict(_fwd_plan(n, w, bits, c, bool(masked), sms, blocks_per_sm,
                          (SMEM_TABLE_MAX, FWD_BLOCKS_MAX)))


@functools.lru_cache(maxsize=256)
def _fwd_plan(n: int, w: int, bits: int, c: int, masked: bool, sms: int,
              blocks_per_sm, limits: tuple) -> dict:
    # limits: SMEM_TABLE_MAX and FWD_BLOCKS_MAX at the call, in the key
    # alone (the helpers read the module's)
    fp = (w * (32 // bits)) << bits
    tiles = -(-n // FWD_THREADS)
    fit = fwd_class_tile(fp)   # 0 at 16-bit fields
    if fit == 0:
        return dict(form="mem", threads=FWD_THREADS, tiles=tiles,
                    class_tile=0, smem=0, grid=(tiles, 1))
    tile = min(fit, c)
    class_tiles = -(-c // tile)
    smem = 4 * tile * fp
    if blocks_per_sm is None:
        blocks_per_sm = _fwd_occupancy(bits, masked, smem)
    grid_x = max(1, min(tiles, FWD_BLOCKS_MAX,
                        sms * blocks_per_sm // class_tiles))
    return dict(form="smem", threads=FWD_THREADS, tiles=tiles,
                class_tile=tile, smem=smem, blocks_per_sm=blocks_per_sm,
                tiles_per_block=-(-tiles // grid_x),
                grid=(grid_x, class_tiles))


def bwd_group_chunks(c: int, fp: int, n_chunks: int) -> int:
    """Chunks whose partials [chunks, C, F*P] fit ``PART_BYTES_MAX``
    (at least one)."""
    return max(1, min(n_chunks, PART_BYTES_MAX // (4 * c * fp)))


def bwd_classes_per_thread(bits: int, c: int) -> int:
    """CT, the classes a thread of the tiled partial kernel adds for: 1 at
    C = 1, else the most whose accumulators fit 32 registers (8 at 1- and
    2-bit fields, 2 at 4-bit), so that a field's decode serves them all."""
    return 1 if c == 1 else min(8, 32 >> bits)


def bwd_fields_per_thread(bits: int, ct: int) -> int:
    """FT, the fields of one word a thread owns: FT * P * CT = 32
    accumulators (``fields_per_thread`` of the source)."""
    return max(1, (32 >> bits) // ct)


def _r4(x: int) -> int:
    return (x + 3) & ~3


def _slot_words(tr: int, w: int, gp: int) -> int:
    """A ring slot, in 4-byte words: the words [W][row pitch] (tr rounded
    to 4, plus 4 where that is a multiple of 8), g [tr][gp] and the
    validity words covering tr rows (and one more, which a funnel shift of
    the last may read)."""
    pitch = _r4(tr) + (4 if _r4(tr) % 8 == 0 else 0)
    return w * pitch + _r4(tr * gp) + _r4(tr // 32 + 3)


def _tile_rows(rows: int, w: int, gp: int):
    """The tile rows of a chunk of ``rows`` rows: as few tiles as fit a
    ``SLOT_BYTES`` slot, each a multiple of 32 rows when it has 32 or
    more (or the whole chunk); one row where even that exceeds the slot.
    None where two slots of one row exceed ``SMEM_BLOCK_MAX``."""
    if 8 * _slot_words(1, w, gp) > SMEM_BLOCK_MAX:
        return None
    tiles = 1
    while True:
        tr = -(-rows // tiles)
        if tr >= 32:
            tr = min(rows, 32 * -(-tr // 32))
        if tr == 1 or 4 * _slot_words(tr, w, gp) <= SLOT_BYTES:
            return tr
        tiles += 1


def _bwd_occupancy(bits: int, ct: int, masked: bool, threads: int,
                   smem: int) -> int:
    from repro_torch.kernels import _build
    key = (bits, ct, masked, threads, smem)
    if key not in _occupancy:
        fn = _build.function("packed_linear", "packed_linear_bwd_occupancy",
                             [_I, _I, _I, _I, _I, ctypes.POINTER(_I)])
        blocks = _I(0)
        err = fn(bits, ct, int(masked), threads, smem, ctypes.byref(blocks))
        if err or blocks.value < 1:
            raise RuntimeError(f"packed_linear_bwd partial kernel (bits "
                               f"{bits}, CT {ct}, {threads} threads, {smem} "
                               f"B) does not fit an SM: CUDA error {err}")
        _occupancy[key] = blocks.value
    return _occupancy[key]


def bwd_plan(n: int, w: int, bits: int, c: int, block_n: int,
             masked: bool = False, device=None, sms=None,
             blocks_per_sm=None) -> dict:
    """How the backward runs, by shape alone, before any launch.

    ``form``: "tiled" (1-, 2- and 4-bit fields, a chunk's rows staged once
    in shared memory) or "mem" (8 and 16 bits, or rows too wide for two
    slots). For "tiled": classes_per_thread (CT), fields_per_thread (FT),
    items (class groups x field groups), threads and item_groups (the
    items over blocks of at most 256 threads), class_pitch (g's entries a
    staged row), tile_rows and tiles_per_chunk, smem (two slots),
    blocks_per_sm, blocks_per_group (the resident blocks over the item
    groups), chunks_per_block and grid of a full group. Both forms:
    group_chunks (``PART_BYTES_MAX``), fold_slab and fold_grid.
    ``sms`` and ``blocks_per_sm`` stand in for the card's (the tests' way
    to plan without one). Plans are cached by shape, the card's SMs and
    the limits (which the tests shrink)."""
    if sms is None:
        sms = _sm_count(device)
    return dict(_plan(min(block_n, n), -(-n // block_n), w, bits, c,
                      bool(masked), sms, blocks_per_sm,
                      (PART_BYTES_MAX, SLOT_BYTES, SMEM_BLOCK_MAX)))


def _sm_count(device) -> int:
    idx = torch.device("cuda" if device is None else device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sms[idx]


@functools.lru_cache(maxsize=256)
def _plan(rows: int, n_chunks: int, w: int, bits: int, c: int, masked: bool,
          sms: int, blocks_per_sm, limits: tuple) -> dict:
    # limits: PART_BYTES_MAX, SLOT_BYTES and SMEM_BLOCK_MAX at the call, in
    # the key alone (the helpers read the module's)
    p = 1 << bits
    f_all = w * (32 // bits)
    fp = f_all * p
    group = bwd_group_chunks(c, fp, n_chunks)
    out = dict(form="mem", group_chunks=group, fold_slab=FOLD_SLAB,
               fold_grid=c * fp // FOLD_SLAB)
    if bits not in TILED_BITS:
        return out
    ct = bwd_classes_per_thread(bits, c)
    ft = bwd_fields_per_thread(bits, ct)
    nfg = f_all // ft
    items = -(-c // ct) * nfg
    item_groups = -(-items // PART_THREADS)
    threads = 32 * -(-(-(-items // item_groups)) // 32)
    # g's pitch: the most class slots a block's items span, CT a group
    # (a vector of CT loads stays inside its row)
    gp = max(((min(items, i0 + threads) - 1) // nfg - i0 // nfg + 1) * ct
             for i0 in range(0, items, threads))
    tr = _tile_rows(rows, w, gp)
    if tr is None:
        return out
    smem = 8 * _slot_words(tr, w, gp)
    if blocks_per_sm is None:
        blocks_per_sm = _bwd_occupancy(bits, ct, masked, threads, smem)
    per_group = max(1, sms * blocks_per_sm // item_groups)
    cpb = -(-group // per_group)
    out.update(form="tiled", classes_per_thread=ct, fields_per_thread=ft,
               items=items, threads=threads, item_groups=item_groups,
               class_pitch=gp, tile_rows=tr, tiles_per_chunk=-(-rows // tr),
               smem=smem, blocks_per_sm=blocks_per_sm,
               blocks_per_group=per_group, chunks_per_block=cpb,
               grid=(-(-group // cpb), item_groups))
    return out


def _check(words: torch.Tensor, bits: int, valid_words) -> tuple:
    if not words.is_cuda or words.dtype != torch.int32 or words.dim() != 2 \
            or not words.is_contiguous():
        raise ValueError(f"words must be a contiguous 2-D int32 CUDA tensor, "
                         f"got {words.dtype} {tuple(words.shape)} on "
                         f"{words.device}")
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"bits must be 1, 2, 4, 8 or 16, got {bits}")
    if valid_words is not None:
        check_valid(valid_words, words)
    n, w = words.shape
    return n, w, (w * (32 // bits)) << bits


def _check_float(name: str, t: torch.Tensor, shape: tuple, words) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != words.device:
        raise ValueError(f"{name} must be a contiguous float32 tensor "
                         f"{list(shape)} on {words.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def packed_linear_fwd_cuda(tables: torch.Tensor, words: torch.Tensor,
                           bits: int, valid_words=None) -> torch.Tensor:
    """Launches the forward kernel of the form ``fwd_plan`` picks by
    shape: one thread a row, every class of a block's class tile ->
    float32 margins [C, N]; with ``valid_words`` (int32 [ceil(N/32)])
    dead rows are 0.0."""
    global launches, masked_launches
    from repro_torch.kernels import _build
    n, w, fp = _check(words, bits, valid_words)
    c = tables.shape[0] if tables.dim() == 2 else -1
    _check_float("tables", tables, (c, fp), words)
    out = torch.empty((c, n), dtype=torch.float32, device=words.device)
    if c == 0 or n == 0:
        return out
    p = fwd_plan(n, w, bits, c, masked=valid_words is not None,
                 device=words.device)
    fn = _build.function("packed_linear", "packed_linear_fwd_launch",
                         [_P, _P, _P, _P] + [_I] * 7 + [_P])
    err = fn(tables.data_ptr(), words.data_ptr(), _ptr(valid_words),
             out.data_ptr(), c, n, w, bits, p["class_tile"], p["smem"],
             p["grid"][0],
             torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_linear_fwd kernel launch failed: CUDA "
                           f"error {err}")
    if valid_words is None:
        launches += 1
    else:
        masked_launches += 1
    return out


def packed_linear_bwd_cuda(g: torch.Tensor, words: torch.Tensor, bits: int,
                           block_n: int = 512,
                           valid_words=None) -> torch.Tensor:
    """Launches the backward kernels: per group of ``block_n``-row chunks,
    the partial kernel (the form ``bwd_plan`` picks by shape) then the
    fold -> float32 table gradients [C, F*P]; with ``valid_words`` dead
    rows add nothing."""
    global bwd_launches, bwd_masked_launches
    from repro_torch.kernels import _build
    n, w, fp = _check(words, bits, valid_words)
    c = g.shape[0] if g.dim() == 2 else -1
    _check_float("g", g, (c, n), words)
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    if c == 0 or n == 0:
        return torch.zeros((c, fp), dtype=torch.float32, device=words.device)
    out = torch.empty((c, fp), dtype=torch.float32, device=words.device)
    p = bwd_plan(n, w, bits, c, block_n, masked=valid_words is not None,
                 device=words.device)
    part = torch.empty((p["group_chunks"], c, fp), dtype=torch.float32,
                       device=words.device)
    fn = _build.function("packed_linear", "packed_linear_bwd_launch",
                         [_P, _P, _P, _P, _P] + [_I] * 14 + [_P])
    err = fn(g.data_ptr(), words.data_ptr(), _ptr(valid_words),
             part.data_ptr(), out.data_ptr(), c, n, w, bits, block_n,
             p["group_chunks"], *_tiled_args(p),
             torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_linear_bwd kernel launch failed: CUDA "
                           f"error {err}")
    if valid_words is None:
        bwd_launches += 1
    else:
        bwd_masked_launches += 1
    return out


def _tiled_args(p: dict) -> list:
    """The C launch's tiled-kernel arguments of a plan: ct 0 for the 8-
    and 16-bit form."""
    if p["form"] != "tiled":
        return [0] * 8
    return [p[k] for k in ("classes_per_thread", "threads", "item_groups",
                           "tile_rows", "tiles_per_chunk", "class_pitch",
                           "smem", "blocks_per_group")]


def bwd_partials_cuda(g: torch.Tensor, words: torch.Tensor, bits: int,
                      block_n: int = 512, valid_words=None) -> torch.Tensor:
    """The backward's partial kernel alone, for timing and checks: the
    partials [chunks, C, F*P] of every ``block_n``-row chunk, where they
    fit one group. Not a path's launch: no counter moves."""
    from repro_torch.kernels import _build
    n, w, fp = _check(words, bits, valid_words)
    c = g.shape[0] if g.dim() == 2 else -1
    _check_float("g", g, (c, n), words)
    if block_n < 1 or c < 1 or n < 1:
        raise ValueError(f"needs block_n, C and N of at least 1, got "
                         f"{block_n}, {c}, {n}")
    p = bwd_plan(n, w, bits, c, block_n, masked=valid_words is not None,
                 device=words.device)
    n_chunks = -(-n // block_n)
    if p["group_chunks"] < n_chunks:
        raise ValueError(f"{n_chunks} chunks of partials exceed one group "
                         f"of {p['group_chunks']}")
    part = torch.empty((n_chunks, c, fp), dtype=torch.float32,
                       device=words.device)
    fn = _build.function("packed_linear", "packed_linear_bwd_partial_launch",
                         [_P, _P, _P, _P] + [_I] * 14 + [_P])
    err = fn(g.data_ptr(), words.data_ptr(), _ptr(valid_words),
             part.data_ptr(), c, n, w, bits, block_n, n_chunks,
             *_tiled_args(p),
             torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_linear_bwd partial kernel launch failed: "
                           f"CUDA error {err}")
    return part


def bwd_fold_cuda(part: torch.Tensor) -> torch.Tensor:
    """The backward's fold alone: partials float32 [chunks, C, F*P] ->
    their sum [C, F*P] in chunk order from 0.0. Not a path's launch: no
    counter moves."""
    from repro_torch.kernels import _build
    if not part.is_cuda or part.dtype != torch.float32 or part.dim() != 3 \
            or not part.is_contiguous() or part.shape[0] < 1 \
            or (part.shape[1] * part.shape[2]) % 64:
        raise ValueError(f"part must be a contiguous float32 CUDA tensor "
                         f"[chunks >= 1, C, F*P] with C*F*P a multiple of 64, "
                         f"got {part.dtype} {tuple(part.shape)} on "
                         f"{part.device}")
    out = torch.empty(part.shape[1:], dtype=torch.float32, device=part.device)
    fn = _build.function("packed_linear", "packed_linear_bwd_fold_launch",
                         [_P, _P, ctypes.c_longlong, _I, _P])
    err = fn(part.data_ptr(), out.data_ptr(), part.shape[1] * part.shape[2],
             part.shape[0], torch.cuda.current_stream(part.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_linear_bwd fold launch failed: CUDA error "
                           f"{err}")
    return out
