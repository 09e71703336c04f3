"""Wrapper of the bit-packing CUDA kernel (``csrc/pack_codes.cu``).

Counterpart of ``repro/kernels/pack_codes.py::pack_codes_pallas``: int32
codes [M, K] -> words [M, ceil(K*b/32)] (int32 bit-views of uint32).
``pack_plan`` picks the form (16-byte or 4-byte code loads), the threads
a block and the grid by shape before the launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.packing import codes_per_word, packed_width

__all__ = ["pack_codes_cuda", "pack_plan", "THREADS", "launches"]

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


THREADS = (128, 256, 512, 1024)   # a block's most threads (launch knob)
THREADS_PER_SM = 2048             # an SM's resident threads (Hopper)
BLOCKS_PER_SM = 32                # an SM's resident blocks (Hopper)


def pack_plan(m: int, k: int, bits: int, sms: int, aligned: bool,
              threads: int = 256) -> dict:
    """How the packing kernel runs, by shape alone, before the launch.

    ``form``: "16-byte" where rows are 16-byte aligned (``aligned``, the
    codes' base address, and K % 4 == 0: a lane loads 4 codes at once,
    ``vec`` 4), else "4-byte" (a lane loads one code, ``vec`` 1).
    ``slots``: a row's slots (a lane's ``vec`` codes), padded to whole
    words; ``lanes_per_word`` (1 to 32) add into one word, or a lane owns
    ``words_per_lane`` words (16-bit codes at ``vec`` 4); ``dense``: the
    slots hold exactly K codes a row (no padding), so the kernel indexes
    them over the whole array. ``threads``:
    the knob, cut to whole warps where fewer lanes a block are needed to
    give the card's ``sms`` a block each; ``grid``: one slot a lane,
    capped at the card's ``resident`` blocks, which then walk the slots
    grid-stride, ``row_step`` rows and ``slot_step`` slots a stride.
    Plans are cached by their arguments."""
    if threads not in THREADS:
        raise ValueError(f"threads must be in {THREADS}, got {threads}")
    return dict(_pack_plan(int(m), int(k), int(bits), int(sms),
                           bool(aligned), int(threads)))


@functools.lru_cache(maxsize=256)
def _pack_plan(m: int, k: int, bits: int, sms: int, aligned: bool,
               threads: int) -> dict:
    cpw = codes_per_word(bits)
    w = packed_width(k, bits)
    vec = 4 if aligned and k % 4 == 0 else 1
    lanes = max(1, cpw // vec)
    slots = w * lanes if cpw >= vec else k // vec
    total = m * slots
    t = threads
    if total < t * sms:   # spread the slots over at least sms blocks
        t = min(threads, max(32, total // sms // 32 * 32))
    resident = sms * min(BLOCKS_PER_SM, THREADS_PER_SM // t)
    grid = min(-(-total // t), resident)
    row_step, slot_step = divmod(grid * t, slots) if slots else (0, 0)
    return dict(form="16-byte" if vec == 4 else "4-byte", vec=vec,
                slots=slots, dense=slots * vec == k, words=w,
                lanes_per_word=lanes, words_per_lane=max(1, vec // cpw),
                threads=t, grid=grid, resident=resident, row_step=row_step,
                slot_step=slot_step)


def pack_codes_cuda(codes: torch.Tensor, bits: int,
                    threads: int = 256) -> torch.Tensor:
    """Launches the packing kernel ``pack_plan`` plans, at most
    ``threads`` a block -> int32 words [M, W]."""
    global launches
    from repro_torch.kernels import _build
    from repro_torch.kernels.packed_linear import _sm_count
    if not codes.is_cuda or codes.dtype != torch.int32 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous 2-D int32 CUDA tensor, "
                         f"got {codes.dtype} {tuple(codes.shape)} on "
                         f"{codes.device}")
    m, k = codes.shape
    p = pack_plan(m, k, bits, _sm_count(codes.device),
                  codes.data_ptr() % 16 == 0, threads)
    out = torch.empty((m, p["words"]), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    fn = _build.function("pack_codes", "pack_codes_launch",
                         [_P, _P, _L, _I, _I, _I, _I, _I, _L, _I, _I, _I,
                          _P])
    err = fn(codes.data_ptr(), out.data_ptr(), m, k, bits, p["vec"],
             p["slots"], p["words"], p["row_step"], p["slot_step"],
             p["grid"], p["threads"],
             torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError(f"pack_codes kernel launch failed: CUDA error {err}")
    launches += 1
    return out
