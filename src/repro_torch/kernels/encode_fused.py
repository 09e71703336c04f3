"""Wrapper of the fused project -> code -> pack CUDA kernel
(``csrc/coded_gemm.cu``, the packing epilogue).

Counterpart of ``repro/kernels/encode_fused.py::encode_fused_pallas``:
x float32 [M, D] @ r float32 [D, K] -> packed words [M, ceil(K*b/32)]
(int32 bit-views of uint32); neither projections nor codes reach device
memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import packed_width
from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels.proj_code import SCHEME_IDS, check_gemm_args

__all__ = ["encode_fused_cuda", "launches"]

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int


def encode_fused_cuda(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                      q=None) -> torch.Tensor:
    """Launches the fused encode kernel -> int32 words [M, W]."""
    global launches
    from repro_torch.kernels import _build
    q_ptr = check_gemm_args(x, r, spec, q)
    m, d = x.shape
    k = r.shape[1]
    out = torch.empty((m, packed_width(k, spec.bits)), dtype=torch.int32,
                      device=x.device)
    if m == 0 or k == 0:
        return out
    fn = _build.function("coded_gemm", "encode_fused_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                          _I, _I, _P])
    err = fn(x.data_ptr(), r.data_ptr(), q_ptr, out.data_ptr(), m, d, k,
             SCHEME_IDS[spec.scheme], float(spec.w), spec.n_bins_side,
             spec.bits, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"encode_fused kernel launch failed: CUDA error {err}")
    launches += 1
    return out
