"""Wrappers of the fused project -> code -> pack CUDA kernel
(``csrc/coded_gemm.cu``, the packing epilogue) and of the epilogue alone
(``csrc/code_pack.cu``).

Counterparts of ``repro/kernels/encode_fused.py``:
``encode_fused_pallas``, x float32 [M, D] @ r float32 or bf16 [D, K]
(3xTF32 on the tensor cores, as ``proj_code``) -> packed words
[M, ceil(K*b/32)] (int32 bit-views of uint32), neither projections nor
codes reaching device memory; and ``code_pack_pallas``, projected z
float32 or bf16 [M, K] -> the same words, the finalize of every
streamed and CSR chunk (``threads`` a block is its launch knob).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import packed_width
from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels.pack_codes import THREADS
from repro_torch.kernels.proj_code import (SCHEME_IDS, check_offsets,
                                           launch_gemm)

__all__ = ["encode_fused_cuda", "code_pack_cuda", "launches",
           "code_pack_launches"]

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0
code_pack_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def encode_fused_cuda(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                      q=None, *, r_split=None) -> torch.Tensor:
    """Launches the fused encode kernel -> int32 words [M, W];
    ``r_split`` is ``proj_code.split_r(r)`` (split for this call when
    None)."""
    global launches
    out = torch.empty((x.shape[0], packed_width(r.shape[1], spec.bits)),
                      dtype=torch.int32, device=x.device)
    if launch_gemm(x, r, spec, q, r_split, out, spec.bits, "encode_fused"):
        launches += 1
    return out


def code_pack_cuda(z: torch.Tensor, spec: CodeSpec, q=None,
                   threads: int = 256) -> torch.Tensor:
    """Launches the code-and-pack kernel, ``threads`` a block -> int32
    words [M, W]."""
    global code_pack_launches
    from repro_torch.kernels import _build
    if not z.is_cuda or z.dtype not in (torch.float32, torch.bfloat16) \
            or z.dim() != 2 or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous 2-D float32 or bf16 CUDA "
                         f"tensor, got {z.dtype} {tuple(z.shape)} on "
                         f"{z.device}")
    if threads not in THREADS:
        raise ValueError(f"threads must be in {THREADS}, got {threads}")
    m, k = z.shape
    q_ptr = check_offsets(z, k, spec, q)
    out = torch.empty((m, packed_width(k, spec.bits)), dtype=torch.int32,
                      device=z.device)
    if out.numel() == 0:
        return out
    fn = _build.function("code_pack", "code_pack_launch",
                         [_P, _I, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I,
                          _I, _P])
    err = fn(z.data_ptr(), int(z.dtype == torch.bfloat16), q_ptr,
             out.data_ptr(), m, k, SCHEME_IDS[spec.scheme], float(spec.w),
             spec.n_bins_side, spec.bits, threads,
             torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"code_pack kernel launch failed: CUDA error {err}")
    code_pack_launches += 1
    return out
