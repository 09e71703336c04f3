"""Wrapper of the bit-packing CUDA kernel (``csrc/pack_codes.cu``).

Counterpart of ``repro/kernels/pack_codes.py::pack_codes_pallas``: int32
codes [M, K] -> words [M, ceil(K*b/32)] (int32 bit-views of uint32).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import packed_width

__all__ = ["pack_codes_cuda", "THREADS", "launches"]

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int


THREADS = (128, 256, 512, 1024)   # a block's threads (launch knob)


def pack_codes_cuda(codes: torch.Tensor, bits: int,
                    threads: int = 256) -> torch.Tensor:
    """Launches the packing kernel, ``threads`` a block -> int32 words
    [M, W]."""
    global launches
    from repro_torch.kernels import _build
    if not codes.is_cuda or codes.dtype != torch.int32 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous 2-D int32 CUDA tensor, "
                         f"got {codes.dtype} {tuple(codes.shape)} on "
                         f"{codes.device}")
    if threads not in THREADS:
        raise ValueError(f"threads must be in {THREADS}, got {threads}")
    m, k = codes.shape
    out = torch.empty((m, packed_width(k, bits)), dtype=torch.int32,
                      device=codes.device)
    if out.numel() == 0:
        return out
    fn = _build.function("pack_codes", "pack_codes_launch",
                         [_P, _P, _I, _I, _I, _I, _P])
    err = fn(codes.data_ptr(), out.data_ptr(), m, k, bits, threads,
             torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError(f"pack_codes kernel launch failed: CUDA error {err}")
    launches += 1
    return out
