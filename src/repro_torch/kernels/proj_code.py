"""Wrapper of the coded-projection CUDA kernel (``csrc/coded_gemm.cu``).

Counterpart of ``repro/kernels/proj_code.py::coded_project_pallas``:
x float32 [M, D] @ r float32 [D, K] -> int32 codes [M, K], the projection
never written to device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schemes import CodeSpec

__all__ = ["coded_project_cuda", "SCHEME_IDS", "launches"]

SCHEME_IDS = {"sign": 0, "2bit": 1, "uniform": 2, "offset": 3}
launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_gemm_args(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec, q):
    """Validates the GEMM kernels' inputs -> the offset pointer (or None)."""
    for name, t in (("x", x), ("r", r)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 CUDA "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if x.shape[1] != r.shape[0] or x.device != r.device:
        raise ValueError(f"x {tuple(x.shape)} and r {tuple(r.shape)} do not "
                         f"chain on one device")
    if spec.scheme not in SCHEME_IDS:
        raise ValueError(f"unknown scheme {spec.scheme!r}")
    if spec.scheme != "offset":
        return None
    if q is None or q.device != x.device or q.dtype != torch.float32 \
            or q.shape != (r.shape[1],) or not q.is_contiguous():
        raise ValueError("offset scheme needs q: contiguous float32 [K] on "
                         "x's device")
    return q.data_ptr()


def coded_project_cuda(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                       q=None) -> torch.Tensor:
    """Launches the coded-projection kernel -> int32 codes [M, K]."""
    global launches
    from repro_torch.kernels import _build
    q_ptr = check_gemm_args(x, r, spec, q)
    m, d = x.shape
    k = r.shape[1]
    out = torch.empty((m, k), dtype=torch.int32, device=x.device)
    if m == 0 or k == 0:
        return out
    fn = _build.function("coded_gemm", "coded_project_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                          _I, _P])
    err = fn(x.data_ptr(), r.data_ptr(), q_ptr, out.data_ptr(), m, d, k,
             SCHEME_IDS[spec.scheme], float(spec.w), spec.n_bins_side,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"coded_project kernel launch failed: CUDA error {err}")
    launches += 1
    return out
