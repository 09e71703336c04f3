"""Wrappers of the R-unit draw (``csrc/normal_unit.cu``).

Counterpart of the draw inside ``repro/core/sketch.py:104-113``
(``_block_r``, which JAX traces into every streamed and CSR step): unit
u of R is ``normal(fold_in(PRNGKey(seed), u), (width, k))``, float32 or
bf16, drawn straight into device memory and bit-identical to
``core.prng.normal``. ``normal_from_bits_cuda`` applies the kernel's
bits -> normal mapping to given bits, for the check over all 2^23
mantissas.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["normal_unit_cuda", "normal_from_bits_cuda", "launches",
           "bits_launches"]

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0
bits_launches = 0

_P = ctypes.c_void_p
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64


def normal_unit_cuda(key: tuple, width: int, k: int, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launches the draw under the unit key (two uint32 words) -> float32
    or bf16 [width, k] on ``device``."""
    global launches
    from repro_torch.kernels import _build
    if torch.device(device).type != "cuda":
        raise ValueError(f"normal_unit draws on a CUDA device, got {device}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normal_unit draws float32 or bfloat16, got "
                         f"{dtype}")
    out = torch.empty((width, k), dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    name = ("normal_unit_launch" if dtype == torch.float32
            else "normal_unit_bf16_launch")
    fn = _build.function("normal_unit", name, [_U32, _U32, _P, _U64, _P])
    err = fn(key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF, out.data_ptr(),
             out.numel(), torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"normal_unit kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def normal_from_bits_cuda(bits: torch.Tensor) -> torch.Tensor:
    """Launches the bits -> normal mapping on int32 bit-views of uint32
    bits [...] -> float32 of the same shape."""
    global bits_launches
    from repro_torch.kernels import _build
    if not bits.is_cuda or bits.dtype != torch.int32 \
            or not bits.is_contiguous():
        raise ValueError(f"bits must be a contiguous int32 CUDA tensor, got "
                         f"{bits.dtype} {tuple(bits.shape)} on {bits.device}")
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    if out.numel() == 0:
        return out
    fn = _build.function("normal_unit", "normal_bits_launch", [_P, _P, _U64, _P])
    err = fn(bits.data_ptr(), out.data_ptr(), out.numel(),
             torch.cuda.current_stream(bits.device).cuda_stream)
    if err:
        raise RuntimeError(f"normal_bits kernel launch failed: CUDA error {err}")
    bits_launches += 1
    return out
