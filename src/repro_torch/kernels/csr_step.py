"""Wrapper of the CSR unit step (``csrc/csr_step.cu``).

Counterpart of ``repro/encode/encoder.py:100-108`` (``_sparse_step``,
a gather and a segment_sum that JAX leaves to XLA): for one unit of R,
each entry's product val * R_u[col - lo] is added to acc[row], a row's
entries in CSR order, in place on the float32 accumulator and
deterministic (no float atomics).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["csr_unit_step_cuda", "launches"]

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


def csr_unit_step_cuda(acc: torch.Tensor, indptr: torch.Tensor,
                       indices: torch.Tensor, data: torch.Tensor,
                       r: torch.Tensor, lo: int) -> torch.Tensor:
    """Launches the step over the CSR arrays (indptr int64 [n+1], indices
    int32 [nnz], data float32 [nnz]) and the unit r float32 [width, k]
    starting at column ``lo``; updates and returns acc float32 [n, k]."""
    global launches
    from repro_torch.kernels import _build
    for name, t, dt in (("acc", acc, torch.float32),
                        ("indptr", indptr, torch.int64),
                        ("indices", indices, torch.int32),
                        ("data", data, torch.float32),
                        ("r", r, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous() \
                or t.device != acc.device:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"one CUDA device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    n, k = acc.shape
    if indptr.shape != (n + 1,) or indices.shape != data.shape \
            or r.dim() != 2 or r.shape[1] != k:
        raise ValueError(f"acc {tuple(acc.shape)}, indptr "
                         f"{tuple(indptr.shape)}, indices "
                         f"{tuple(indices.shape)}, data {tuple(data.shape)} "
                         f"and r {tuple(r.shape)} do not fit together")
    if n == 0 or k == 0 or indices.numel() == 0 or r.shape[0] == 0:
        return acc
    fn = _build.function("csr_step", "csr_unit_step_launch",
                         [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P])
    err = fn(acc.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
             data.data_ptr(), r.data_ptr(), n, k, int(lo), r.shape[0],
             torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(f"csr_unit_step kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return acc
