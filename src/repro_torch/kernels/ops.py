"""Dispatch between the CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py:51-182, 278-332``. ``impl``:

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

from repro_torch.core import prng as _prng
from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels import csr_step as _csr_step
from repro_torch.kernels import encode_fused as _encode_fused
from repro_torch.kernels import fused_scored as _fused_scored
from repro_torch.kernels import normal_unit as _normal_unit
from repro_torch.kernels import pack_codes as _pack_codes
from repro_torch.kernels import packed_collision as _packed_collision
from repro_torch.kernels import packed_lut as _packed_lut
from repro_torch.kernels import proj_code as _proj_code
from repro_torch.kernels import ref as _ref

__all__ = ["coded_project", "encode_fused", "code_pack", "normal_unit",
           "normal_from_bits", "csr_unit_step", "pack_codes", "packed_topk",
           "packed_topk_masked", "packed_collision_counts",
           "packed_lut_rerank", "fused_scored_topk", "fused_scored_topk_masked",
           "launch_counts", "reset_launch_counts"]

# wrapper name -> (module, its launch counter)
_WRAPPERS = {"coded_project": (_proj_code, "launches"),
             "encode_fused": (_encode_fused, "launches"),
             "code_pack": (_encode_fused, "code_pack_launches"),
             "normal_unit": (_normal_unit, "launches"),
             "normal_from_bits": (_normal_unit, "bits_launches"),
             "csr_unit_step": (_csr_step, "launches"),
             "pack_codes": (_pack_codes, "launches"),
             "packed_topk": (_packed_collision, "launches"),
             "packed_topk_masked": (_packed_collision, "masked_launches"),
             "packed_collision_counts": (_packed_collision, "counts_launches"),
             "packed_lut_rerank": (_packed_lut, "launches"),
             "fused_scored_topk": (_fused_scored, "launches"),
             "fused_scored_topk_masked": (_fused_scored, "masked_launches")}


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    return _kernel_on(impl, t.device)


def _kernel_on(impl: str, device: torch.device) -> bool:
    if impl == "ref":
        return False
    if impl == "auto":
        return device.type == "cuda"
    if impl == "kernel":
        if device.type != "cuda":
            raise ValueError("impl='kernel' runs the CUDA kernel and needs "
                             f"CUDA tensors, got a tensor on {device}")
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


def code_pack(z: torch.Tensor, spec: CodeSpec, q=None,
              impl: str = "auto") -> torch.Tensor:
    """pack(encode(z)) of projected float32 z [M, K] -> int32 words
    [M, ceil(K*b/32)] (the finalize of the streamed and CSR regimes)."""
    if _use_kernel(impl, z):
        return _encode_fused.code_pack_cuda(z.contiguous(), spec, q)
    return _ref.code_pack_ref(z, spec, q)


def normal_unit(key: tuple, width: int, k: int, device,
                impl: str = "auto") -> torch.Tensor:
    """Unit of R under its key (``prng.fold_in(PRNGKey(seed), u)``):
    float32 [width, k] standard normals on ``device``, bit-identical to
    ``jax.random.normal``."""
    device = torch.device(device)
    if _kernel_on(impl, device):
        return _normal_unit.normal_unit_cuda(key, width, k, device)
    return _prng.normal(key, (width, k), device)


def normal_from_bits(bits: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """int32 bit-views of uint32 bits -> the float32 normals that
    ``jax.random.normal`` makes of them (the draw's last stage)."""
    if _use_kernel(impl, bits):
        return _normal_unit.normal_from_bits_cuda(bits.contiguous())
    return _prng.normal_from_bits(bits.to(torch.int64) & 0xFFFFFFFF)


def csr_unit_step(acc: torch.Tensor, indptr: torch.Tensor,
                  indices: torch.Tensor, data: torch.Tensor, r: torch.Tensor,
                  lo: int, impl: str = "auto") -> torch.Tensor:
    """One unit's CSR step, in place: acc[row] += val * r[col - lo] for
    each entry with its column in [lo, lo + r.shape[0]), a row's entries
    in CSR order (rows without such an entry untouched) -> acc."""
    if _use_kernel(impl, acc):
        return _csr_step.csr_unit_step_cuda(acc, indptr, indices, data,
                                            r.contiguous(), lo)
    return _ref.csr_unit_step_ref(acc, indptr, indices, data, r, lo)


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


def packed_topk_masked(words_q: torch.Tensor, words_db: torch.Tensor,
                       valid_words: torch.Tensor, bits: int, k: int,
                       top_k: int, impl: str = "auto"):
    """Exact top-k over the live rows of ``valid_words`` int32
    [ceil(N/32)] (bit r % 32 of word r // 32 = row r) -> (counts, ids)
    int32 [Q, top_k]; slots past the live count are (-1, -1)."""
    if _use_kernel(impl, words_q):
        return _packed_collision.packed_topk_masked_cuda(
            words_q.contiguous(), words_db.contiguous(),
            valid_words.contiguous(), bits, k, top_k)
    return _ref.packed_topk_masked_ref(words_q, words_db, valid_words, bits,
                                       k, top_k)


def packed_collision_counts(words_q: torch.Tensor, words_db: torch.Tensor,
                            bits: int, k: int,
                            impl: str = "auto") -> torch.Tensor:
    """All-pairs collision counts: int32 words [Q, W] x [N, W] -> int32
    [Q, N]."""
    if _use_kernel(impl, words_q):
        return _packed_collision.packed_collision_counts_cuda(
            words_q.contiguous(), words_db.contiguous(), bits, k)
    return _ref.packed_collision_ref(words_q, words_db, bits, k)


def packed_lut_rerank(q_tables: torch.Tensor, cand_words: torch.Tensor,
                      cand_valid: torch.Tensor, bits: int, top_k: int,
                      impl: str = "auto"):
    """Re-rank gathered candidates [Q, M, W] by per-query LUT score ->
    (scores float32, candidate positions int32) [Q, top_k]."""
    if _use_kernel(impl, cand_words):
        return _packed_lut.packed_lut_rerank_cuda(
            q_tables.contiguous(), cand_words.contiguous(),
            (cand_valid != 0).contiguous(), bits, top_k)
    return _ref.packed_lut_rerank_ref(q_tables, cand_words, cand_valid, bits,
                                      top_k)


def fused_scored_topk(q_words: torch.Tensor, q_tables: torch.Tensor,
                      words_db: torch.Tensor, bits: int, k: int,
                      rerank_m: int, top_k: int, scales=None,
                      impl: str = "auto"):
    """Top-``top_k`` by LUT score over the stable top-``rerank_m`` by
    collision count -> (scores float32, corpus ids int32) [Q, top_k].
    ``scales`` float32 [Q, W] (powers of two) selects the int8 tables."""
    if _use_kernel(impl, q_words):
        return _fused_scored.fused_scored_topk_cuda(
            q_words.contiguous(), q_tables.contiguous(),
            words_db.contiguous(), bits, k, rerank_m, top_k,
            None if scales is None else scales.contiguous())
    return _ref.fused_scored_topk_ref(q_words, q_tables, words_db, bits, k,
                                      rerank_m, top_k, scales=scales)


def fused_scored_topk_masked(q_words: torch.Tensor, q_tables: torch.Tensor,
                             words_db: torch.Tensor, valid_words: torch.Tensor,
                             bits: int, k: int, rerank_m: int, top_k: int,
                             scales=None, impl: str = "auto"):
    """``fused_scored_topk`` over the live rows of ``valid_words`` int32
    [ceil(N/32)]: dead rows take count -1 before the survivor rule."""
    if _use_kernel(impl, q_words):
        return _fused_scored.fused_scored_topk_masked_cuda(
            q_words.contiguous(), q_tables.contiguous(),
            words_db.contiguous(), valid_words.contiguous(), bits, k,
            rerank_m, top_k, None if scales is None else scales.contiguous())
    return _ref.fused_scored_topk_masked_ref(q_words, q_tables, words_db,
                                             valid_words, bits, k, rerank_m,
                                             top_k, scales=scales)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Sets every wrapper's launch count to 0."""
    for mod, attr in _WRAPPERS.values():
        setattr(mod, attr, 0)
