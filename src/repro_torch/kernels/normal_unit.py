"""Wrappers of the R-unit draw (``csrc/normal_unit.cu``).

Counterpart of the draw inside ``repro/core/sketch.py:104-113``
(``_block_r``, which JAX traces into every streamed and CSR step): unit
u of R is ``normal(fold_in(PRNGKey(seed), u), (width, k))``, float32 or
bf16, drawn straight into device memory and bit-identical to
``core.prng.normal``. ``normal_unit_group_cuda`` draws up to 16 units
(a group of the CSR path) in one launch, each into its slot of a buffer.
``normal_from_bits_cuda`` applies the kernel's bits -> normal mapping to
given bits, for the check over all 2^23 mantissas.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["normal_unit_cuda", "normal_unit_group_cuda",
           "normal_from_bits_cuda", "launches", "group_launches",
           "bits_launches", "MAX_UNITS"]

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0
group_launches = 0
bits_launches = 0

MAX_UNITS = 16        # units of one launch (their keys go by value)

_P = ctypes.c_void_p
_I = ctypes.c_int
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


def normal_unit_group_cuda(keys: list, widths: list, slots: list,
                           out: torch.Tensor) -> torch.Tensor:
    """Launches the draw of units j = 0.. under ``keys[j]`` (two uint32
    words each), ``widths[j]`` rows each, into ``out[slots[j], :widths[j]]``
    of the float32 or bf16 buffer out [G, r_unit, k]; the rest of ``out``
    is left as it is. Returns out."""
    global group_launches
    from repro_torch.kernels import _build
    if not out.is_cuda or out.dtype not in (torch.float32, torch.bfloat16) \
            or not out.is_contiguous() or out.dim() != 3:
        raise ValueError(f"out must be a contiguous float32 or bfloat16 "
                         f"CUDA tensor [G, r_unit, k], got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    n = len(keys)
    if not n == len(widths) == len(slots) or n > MAX_UNITS \
            or len(set(slots)) != n \
            or not all(0 <= s < out.shape[0] for s in slots) \
            or not all(0 <= w <= out.shape[1] for w in widths):
        raise ValueError(f"{n} keys, widths {list(widths)} and slots "
                         f"{list(slots)} do not fit out {tuple(out.shape)} "
                         f"(at most {MAX_UNITS} units, distinct slots)")
    if n == 0 or out.shape[2] == 0 or max(widths) == 0:
        return out
    flat = [w & 0xFFFFFFFF for key in keys for w in key]
    fn = _build.function("normal_unit", "normal_units_launch",
                         [_P, _P, _P, _I, _I, _I, _P, _U64, _P])
    err = fn((ctypes.c_uint32 * (2 * n))(*flat),
             (ctypes.c_int32 * n)(*slots), (ctypes.c_int32 * n)(*widths), n,
             out.shape[2], int(out.dtype == torch.bfloat16), out.data_ptr(),
             out.shape[1] * out.shape[2],
             torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"normal_units kernel launch failed: CUDA error "
                           f"{err}")
    group_launches += 1
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
