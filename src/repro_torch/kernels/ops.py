"""Dispatch between the CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py:51-164``. ``impl``:

* ``"auto"``: the kernel for CUDA tensors, the plain version (``ref.py``)
  for CPU tensors;
* ``"ref"``: the plain version on any device (tests, and the on-card
  comparisons of ``chip_smoke.py``);
* ``"kernel"``: the kernel; raises for CPU tensors.

A CUDA tensor never falls back to the plain version: the kernel launches
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels import encode_fused as _encode_fused
from repro_torch.kernels import pack_codes as _pack_codes
from repro_torch.kernels import packed_collision as _packed_collision
from repro_torch.kernels import proj_code as _proj_code
from repro_torch.kernels import ref as _ref

__all__ = ["coded_project", "encode_fused", "pack_codes", "packed_topk",
           "launch_counts", "reset_launch_counts"]

_WRAPPERS = {"coded_project": _proj_code, "encode_fused": _encode_fused,
             "pack_codes": _pack_codes, "packed_topk": _packed_collision}


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl == "ref":
        return False
    if impl == "auto":
        return t.is_cuda
    if impl == "kernel":
        if not t.is_cuda:
            raise ValueError("impl='kernel' runs the CUDA kernel and needs "
                             f"CUDA tensors, got a tensor on {t.device}")
        return True
    raise ValueError(f"unknown impl {impl!r}; one of auto, ref, kernel")


def coded_project(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec, q=None,
                  impl: str = "auto") -> torch.Tensor:
    """encode(x @ r): float32 [M, D] x [D, K] -> int32 codes [M, K]."""
    if _use_kernel(impl, x):
        return _proj_code.coded_project_cuda(x.contiguous(), r.contiguous(),
                                             spec, q)
    return _ref.coded_project_ref(x, r, spec, q)


def encode_fused(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec, q=None,
                 impl: str = "auto") -> torch.Tensor:
    """pack(encode(x @ r)): float32 [M, D] x [D, K] -> int32 words
    [M, ceil(K*b/32)], the one-kernel ingest path."""
    if _use_kernel(impl, x):
        return _encode_fused.encode_fused_cuda(x.contiguous(),
                                               r.contiguous(), spec, q)
    return _ref.encode_fused_ref(x, r, spec, q)


def pack_codes(codes: torch.Tensor, bits: int,
               impl: str = "auto") -> torch.Tensor:
    """int32 codes [M, K] -> int32 words [M, ceil(K*b/32)]."""
    if _use_kernel(impl, codes):
        return _pack_codes.pack_codes_cuda(codes.contiguous(), bits)
    return _ref.pack_codes_ref(codes, bits)


def packed_topk(words_q: torch.Tensor, words_db: torch.Tensor, bits: int,
                k: int, top_k: int, impl: str = "auto"):
    """Exact top-k by collision count -> (counts, ids) int32 [Q, top_k]."""
    if _use_kernel(impl, words_q):
        return _packed_collision.packed_topk_cuda(
            words_q.contiguous(), words_db.contiguous(), bits, k, top_k)
    return _ref.packed_topk_ref(words_q, words_db, bits, k, top_k)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Sets every wrapper's launch count to 0."""
    for mod in _WRAPPERS.values():
        mod.launches = 0
