"""Wrappers of the packed-linear CUDA kernels (``csrc/packed_linear.cu``).

Counterparts of ``repro/kernels/packed_linear.py``:

* ``packed_linear_fwd_cuda`` (``packed_linear_fwd_pallas`` and, with
  ``valid_words``, ``packed_linear_fwd_masked_pallas``): float32 class
  tables [C, F*P] x int32 words [N, W] -> float32 margins [C, N], dead
  rows 0.0;
* ``packed_linear_bwd_cuda`` (``packed_linear_bwd_pallas`` and, with
  ``valid_words``, ``packed_linear_bwd_masked_pallas``): float32 margin
  gradients [C, N] x words -> float32 table gradients [C, F*P], in the
  sum order of ``ref.packed_linear_bwd_ref`` at the same ``block_n``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.packed_collision import check_valid

__all__ = ["packed_linear_fwd_cuda", "packed_linear_bwd_cuda",
           "fwd_class_tile", "bwd_group_chunks", "SMEM_TABLE_MAX",
           "PART_BYTES_MAX", "launches", "masked_launches", "bwd_launches",
           "bwd_masked_launches"]

SMEM_TABLE_MAX = 96 * 1024     # shared memory for a block's class tables
PART_BYTES_MAX = 256 << 20     # the backward's partials, a group of chunks
# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0              # packed_linear_fwd
masked_launches = 0       # packed_linear_fwd_masked
bwd_launches = 0          # packed_linear_bwd
bwd_masked_launches = 0   # packed_linear_bwd_masked

_P = ctypes.c_void_p
_I = ctypes.c_int


def fwd_class_tile(fp: int) -> int:
    """Classes a forward block keeps in shared memory for tables of
    ``fp`` float32 entries a class; 0 when one class does not fit (the
    tables are then read from device memory)."""
    return SMEM_TABLE_MAX // (4 * fp)


def bwd_group_chunks(c: int, fp: int, n_chunks: int) -> int:
    """Chunks whose partials [chunks, C, F*P] fit ``PART_BYTES_MAX``
    (at least one)."""
    return max(1, min(n_chunks, PART_BYTES_MAX // (4 * c * fp)))


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
    """Launches the forward kernel: one thread a row, every class of a
    block's class tile -> float32 margins [C, N]; with ``valid_words``
    (int32 [ceil(N/32)]) dead rows are 0.0."""
    global launches, masked_launches
    from repro_torch.kernels import _build
    n, w, fp = _check(words, bits, valid_words)
    c = tables.shape[0] if tables.dim() == 2 else -1
    _check_float("tables", tables, (c, fp), words)
    out = torch.empty((c, n), dtype=torch.float32, device=words.device)
    if c == 0 or n == 0:
        return out
    tile = fwd_class_tile(fp)
    fn = _build.function("packed_linear", "packed_linear_fwd_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    err = fn(tables.data_ptr(), words.data_ptr(), _ptr(valid_words),
             out.data_ptr(), c, n, w, bits, min(tile, c) if tile else c,
             int(tile > 0), torch.cuda.current_stream(words.device).cuda_stream)
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
    the partial kernel then the fold -> float32 table gradients
    [C, F*P]; with ``valid_words`` dead rows add nothing."""
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
    n_chunks = -(-n // block_n)
    group = bwd_group_chunks(c, fp, n_chunks)
    part = torch.empty((group, c, fp), dtype=torch.float32,
                       device=words.device)
    fn = _build.function("packed_linear", "packed_linear_bwd_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    err = fn(g.data_ptr(), words.data_ptr(), _ptr(valid_words),
             part.data_ptr(), out.data_ptr(), c, n, w, bits, block_n, group,
             torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"packed_linear_bwd kernel launch failed: CUDA "
                           f"error {err}")
    if valid_words is None:
        bwd_launches += 1
    else:
        bwd_masked_launches += 1
    return out
