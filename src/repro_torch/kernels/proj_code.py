"""Wrapper of the coded-projection CUDA kernel (``csrc/coded_gemm.cu``).

Counterpart of ``repro/kernels/proj_code.py::coded_project_pallas``:
x float32 [M, D] @ r float32 or bf16 [D, K] -> int32 codes [M, K], the
projection never written to device memory. The kernel takes the product
as three TF32 tensor-core products (3xTF32) on R^T split once by
``split_r``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels import ref as _ref

__all__ = ["coded_project_cuda", "split_r", "launch_gemm", "SCHEME_IDS",
           "check_gemm_args", "check_offsets", "launches"]

SCHEME_IDS = {"sign": 0, "2bit": 1, "uniform": 2, "offset": 3}
launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _padded(d: int) -> int:
    """D rounded up to a multiple of 4: R^T's row length in ``split_r``."""
    return -(-d // 4) * 4


def split_r(r: torch.Tensor) -> torch.Tensor:
    """R [D, K] float32 or bf16 -> the GEMM kernels' operand for it: R^T
    split into TF32 planes (``ref.tf32_split``), float32 [P, K, Dp] with
    P = 2 (hi, lo) for a float32 R and P = 1 (hi; lo is zero) for a bf16
    R, and Dp = D rounded up to a multiple of 4 with zero columns, so
    that every row stride is the 16 bytes' multiple TMA needs. R is
    immutable for a sketch, so callers prepare it once (the encoder
    caches it beside R)."""
    d, k = r.shape
    planes = _ref.tf32_split(r.t())
    if r.dtype == torch.bfloat16:
        planes = planes[:1]
    out = torch.zeros((len(planes), k, _padded(d)), dtype=torch.float32,
                      device=r.device)
    for i, p in enumerate(planes):
        out[i, :, :d] = p
    return out


def check_gemm_args(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec, q):
    """Validates the GEMM kernels' inputs (x float32, r float32 or bf16)
    -> the offset pointer (or None)."""
    for name, t, dtypes in (("x", x, (torch.float32,)),
                            ("r", r, (torch.float32, torch.bfloat16))):
        if not t.is_cuda or t.dtype not in dtypes or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D CUDA tensor "
                             f"of {[str(d) for d in dtypes]}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.shape[1] != r.shape[0] or x.device != r.device:
        raise ValueError(f"x {tuple(x.shape)} and r {tuple(r.shape)} do not "
                         f"chain on one device")
    return check_offsets(x, r.shape[1], spec, q)


def check_offsets(x: torch.Tensor, k: int, spec: CodeSpec, q):
    """Validates the scheme and, for ``offset``, q float32 [k] on x's
    device -> its pointer (or None)."""
    if spec.scheme not in SCHEME_IDS:
        raise ValueError(f"unknown scheme {spec.scheme!r}")
    if spec.scheme != "offset":
        return None
    if q is None or q.device != x.device or q.dtype != torch.float32 \
            or q.shape != (k,) or not q.is_contiguous():
        raise ValueError("offset scheme needs q: contiguous float32 [K] on "
                         "x's device")
    return q.data_ptr()


def launch_gemm(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec, q,
                r_split, out: torch.Tensor, bits: int, what: str) -> bool:
    """Validates the inputs and launches ``coded_gemm_launch`` into
    ``out`` (int32 codes for ``bits`` = 0, else packed words) unless it
    is empty; True if it launched. ``r_split`` is ``split_r(r)`` or None
    (then split for this call)."""
    q_ptr = check_gemm_args(x, r, spec, q)
    if out.numel() == 0:
        return False
    m, d = x.shape
    k = r.shape[1]
    planes = 1 if r.dtype == torch.bfloat16 else 2
    if r_split is None:
        r_split = split_r(r)
    elif r_split.shape != (planes, k, _padded(d)) \
            or r_split.dtype != torch.float32 \
            or r_split.device != x.device or not r_split.is_contiguous():
        raise ValueError(f"r_split must be split_r(r): contiguous float32 "
                         f"{(planes, k, _padded(d))} on x's device, got "
                         f"{r_split.dtype} {tuple(r_split.shape)} on "
                         f"{r_split.device}")
    from repro_torch.kernels import _build
    fn = _build.function("coded_gemm", "coded_gemm_launch",
                         [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                          ctypes.c_float, _I, _I, _P])
    err = fn(x.data_ptr(), r_split.data_ptr(), planes, _padded(d), q_ptr,
             out.data_ptr(), m, d, k, SCHEME_IDS[spec.scheme], float(spec.w),
             spec.n_bins_side, bits,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: error {err} (CUDA "
                           f"error code; 999: no cuTensorMapEncodeTiled; "
                           f"1000 + CUresult: a tensor map refused)")
    return True


def coded_project_cuda(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                       q=None, *, r_split=None) -> torch.Tensor:
    """Launches the coded-projection kernel -> int32 codes [M, K];
    ``r_split`` is ``split_r(r)`` (split for this call when None)."""
    global launches
    out = torch.empty((x.shape[0], r.shape[1]), dtype=torch.int32,
                      device=x.device)
    if launch_gemm(x, r, spec, q, r_split, out, 0, "coded_project"):
        launches += 1
    return out
