"""Wrapper of the unpacked collision-count CUDA kernel
(``csrc/collision.cu``).

Counterpart of ``repro/kernels/collision.py::collision_counts_pallas``:
int32 codes [Q, K] x [N, K], any values -> int32 [Q, N] equality counts.
``block_q`` and ``block_n`` (32, 64 or 128) size the block's tile of
counts; the counts are integers, so they change no bit.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["collision_counts_cuda", "BLOCKS", "launches"]

BLOCKS = (32, 64, 128)   # tile sizes the kernel is instantiated for
launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_P = ctypes.c_void_p
_I = ctypes.c_int


def collision_counts_cuda(codes_q: torch.Tensor, codes_db: torch.Tensor,
                          block_q: int = 64,
                          block_n: int = 128) -> torch.Tensor:
    """Launches the tiled equality-count kernel -> int32 counts [Q, N]."""
    global launches
    from repro_torch.kernels import _build
    for name, t in (("codes_q", codes_q), ("codes_db", codes_db)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 CUDA "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    nq, k = codes_q.shape
    n = codes_db.shape[0]
    if codes_db.shape[1] != k or codes_db.device != codes_q.device:
        raise ValueError(f"codes {tuple(codes_q.shape)} vs "
                         f"{tuple(codes_db.shape)}: widths or devices "
                         f"differ")
    if block_q not in BLOCKS or block_n not in BLOCKS:
        raise ValueError(f"block_q and block_n must be in {BLOCKS}, got "
                         f"{block_q}, {block_n}")
    if -(-nq // block_q) > 65535:
        raise ValueError(f"at most {65535 * block_q} queries a call at "
                         f"block_q={block_q}, got {nq}")
    out = torch.empty((nq, n), dtype=torch.int32, device=codes_q.device)
    if nq == 0 or n == 0:
        return out
    fn = _build.function("collision", "collision_counts_launch",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _P])
    err = fn(codes_q.data_ptr(), codes_db.data_ptr(), out.data_ptr(), nq, n,
             k, block_q, block_n,
             torch.cuda.current_stream(codes_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"collision_counts kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
