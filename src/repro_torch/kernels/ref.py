"""Plain PyTorch versions of the slice's kernels (counterpart of
``repro/kernels/ref.py:30-151``).

They define the semantics the CUDA kernels are held to on the card, and
they are what ``ops`` runs for tensors on the CPU. Integer outputs are
bit-exact against the JAX oracles; the projections follow
``torch.matmul``'s float32 sum order.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing as _packing
from repro_torch.core import schemes as _schemes
from repro_torch.core.schemes import CodeSpec

__all__ = ["coded_project_ref", "pack_codes_ref", "encode_fused_ref",
           "packed_collision_ref", "topk_stable_ref", "packed_topk_ref"]


def coded_project_ref(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                      q=None) -> torch.Tensor:
    """x [M, D] @ r [D, K] in float32 -> int32 codes [M, K]."""
    return _schemes.encode(torch.matmul(x, r), spec, q)


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """int codes [M, K] -> int32 words [M, ceil(K*bits/32)]."""
    return _packing.pack_codes(codes, bits)


def encode_fused_ref(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                     q=None) -> torch.Tensor:
    """x [M, D] @ r [D, K] -> packed int32 words [M, ceil(K*b/32)]."""
    return _packing.pack_codes(coded_project_ref(x, r, spec, q), spec.bits)


def packed_collision_ref(words_q: torch.Tensor, words_db: torch.Tensor,
                         bits: int, k: int,
                         block_elems: int = 1 << 25) -> torch.Tensor:
    """int32 words [Q, W] x [N, W] -> int32 collision counts [Q, N].

    Word by word in int64, over column blocks of at most ``block_elems``
    pairs so the temporaries stay bounded at any corpus size.
    """
    nq, w = words_q.shape
    n = words_db.shape[0]
    uq, udb = _packing.as_u32(words_q), _packing.as_u32(words_db)
    out = torch.empty((nq, n), dtype=torch.int32, device=words_q.device)
    step = max(1, block_elems // max(nq, 1))
    for lo in range(0, n, step):
        blk = udb[lo:lo + step]
        mism = torch.zeros((nq, blk.shape[0]), dtype=torch.int64,
                           device=words_q.device)
        for j in range(w):
            mism += _packing.mismatch_count_words(
                uq[:, None, j] ^ blk[None, :, j], bits)
        out[:, lo:lo + step] = (k - mism).to(torch.int32)
    return out


def topk_stable_ref(m: torch.Tensor, top_k: int):
    """Stable descending top-k of int scores [c, n] -> (values, ids).

    Ties go to the lowest index (``torch.topk`` does not promise that);
    top_k > n pads with -1, and ids are -1 wherever the value is
    negative.
    """
    if top_k > m.shape[1]:
        m = torch.nn.functional.pad(m, (0, top_k - m.shape[1]), value=-1)
    vals, ids = torch.sort(m, dim=1, descending=True, stable=True)
    vals, ids = vals[:, :top_k], ids[:, :top_k].to(torch.int32)
    return vals, torch.where(vals < 0, torch.full_like(ids, -1), ids)


def packed_topk_ref(words_q: torch.Tensor, words_db: torch.Tensor, bits: int,
                    k: int, top_k: int):
    """-> (counts [Q, top_k], ids [Q, top_k]) int32: full count matrix,
    then the stable top-k."""
    return topk_stable_ref(packed_collision_ref(words_q, words_db, bits, k),
                           top_k)
