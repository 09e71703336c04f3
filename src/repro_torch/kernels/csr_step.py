"""Wrappers of the grouped CSR step (``csrc/csr_step.cu``).

Counterpart of ``repro/encode/encoder.py:100-108`` (``_sparse_step``,
a gather and a segment_sum that JAX leaves to XLA, one unit at a time):
for each of G consecutive units of R in ascending order, each entry's
product val * R_u[col - lo_u] is added to acc[row], a row's entries of
one unit in CSR order, in place on the float32 accumulator and
deterministic (no float atomics). One launch takes the whole group;
``csr_unit_step_cuda`` is its launch for one unit.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["csr_group_step_cuda", "csr_unit_step_cuda", "launches",
           "group_launches", "MAX_GROUP"]

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0          # through csr_unit_step_cuda
group_launches = 0    # through csr_group_step_cuda

MAX_GROUP = 32        # units of one launch (a row's units form a bitmask)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


def _launch(acc, indptr, indices, data, r, lo: int, span: int) -> bool:
    """Checks the operands and launches; False where there is no work."""
    from repro_torch.kernels import _build
    for name, t, dts in (("acc", acc, (torch.float32,)),
                         ("indptr", indptr, (torch.int64,)),
                         ("indices", indices, (torch.int32,)),
                         ("data", data, (torch.float32,)),
                         ("r", r, (torch.float32, torch.bfloat16))):
        if not t.is_cuda or t.dtype not in dts or not t.is_contiguous() \
                or t.device != acc.device:
            raise ValueError(f"{name} must be a contiguous "
                             f"{' or '.join(map(str, dts))} tensor on one "
                             f"CUDA device, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    n, k = acc.shape
    if indptr.shape != (n + 1,) or indices.shape != data.shape \
            or r.dim() != 3 or r.shape[2] != k:
        raise ValueError(f"acc {tuple(acc.shape)}, indptr "
                         f"{tuple(indptr.shape)}, indices "
                         f"{tuple(indices.shape)}, data {tuple(data.shape)} "
                         f"and r {tuple(r.shape)} do not fit together")
    g, ru = r.shape[0], r.shape[1]
    if not 1 <= g <= MAX_GROUP or not (g - 1) * ru < span <= g * ru \
            or lo < 0 or lo + span > 2 ** 31 - 1:
        raise ValueError(f"a group of {g} units of {ru} columns cannot "
                         f"cover columns [{lo}, {lo + span}) (1 to "
                         f"{MAX_GROUP} units, the last one not empty)")
    if n == 0 or k == 0 or indices.numel() == 0:
        return False
    fn = _build.function("csr_step", "csr_group_step_launch",
                         [_P, _P, _P, _P, _P, _I, _I64, _I, _I, _I, _I, _I,
                          _P])
    err = fn(acc.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
             data.data_ptr(), r.data_ptr(), int(r.dtype == torch.bfloat16),
             n, k, int(lo), int(span), ru, g,
             torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(f"csr_group_step kernel launch failed: CUDA "
                           f"error {err}")
    return True


def csr_group_step_cuda(acc: torch.Tensor, indptr: torch.Tensor,
                        indices: torch.Tensor, data: torch.Tensor,
                        r: torch.Tensor, lo: int, span: int) -> torch.Tensor:
    """Launches the step of a group over the CSR arrays (indptr int64
    [n+1], indices int32 [nnz], data float32 [nnz]): unit g of r float32
    or bf16 [G, r_unit, k] covers the columns [lo + g * r_unit, lo +
    (g + 1) * r_unit) of [lo, lo + span); updates and returns acc
    float32 [n, k]. A unit no entry falls in is never read."""
    global group_launches
    if _launch(acc, indptr, indices, data, r, lo, span):
        group_launches += 1
    return acc


def csr_unit_step_cuda(acc: torch.Tensor, indptr: torch.Tensor,
                       indices: torch.Tensor, data: torch.Tensor,
                       r: torch.Tensor, lo: int) -> torch.Tensor:
    """Launches the step of one unit r float32 or bf16 [width, k]
    starting at column ``lo`` (the group kernel at G = 1); updates and
    returns acc float32 [n, k]."""
    global launches
    if r.dim() != 2:
        raise ValueError(f"r must be one unit [width, k], got "
                         f"{tuple(r.shape)}")
    if r.shape[0] and _launch(acc, indptr, indices, data, r[None], lo,
                              r.shape[0]):
        launches += 1
    return acc
