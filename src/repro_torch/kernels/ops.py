"""Dispatch between the CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``. ``impl``:

* ``"auto"``: the kernel for CUDA tensors, the plain version (``ref.py``)
  for CPU tensors;
* ``"ref"``: the plain version on any device (tests, and the on-card
  comparisons of ``chip_smoke.py``);
* ``"kernel"``: the kernel; raises for CPU tensors.

A CUDA tensor never falls back to the plain version: the kernel launches
or raises.

Every dispatch first reports its family and shape dims to
``obs.kernelstats`` (calls, modeled FLOPs and bytes; the reference's dims
for its 17 families). Each wrapper takes its kernel's launch knobs as
keyword arguments (``n_ranges``, ``block_q``, ``threads``...; the plain
versions ignore them): knobs the caller passes win, otherwise the
autotune cache is consulted (``autotune.lookup``), and a cold cache
leaves the kernel's defaults. No knob changes an output bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng as _prng
from repro_torch.core.packing import packed_width as _packed_width
from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import collision as _collision
from repro_torch.kernels import csr_step as _csr_step
from repro_torch.kernels import encode_fused as _encode_fused
from repro_torch.kernels import fused_scored as _fused_scored
from repro_torch.kernels import lut_topk as _lut_topk
from repro_torch.kernels import normal_unit as _normal_unit
from repro_torch.kernels import pack_codes as _pack_codes
from repro_torch.kernels import packed_collision as _packed_collision
from repro_torch.kernels import packed_linear as _packed_linear
from repro_torch.kernels import packed_lut as _packed_lut
from repro_torch.kernels import proj_code as _proj_code
from repro_torch.kernels import ref as _ref
from repro_torch.obs import kernelstats as _kstats

__all__ = ["coded_project", "encode_fused", "split_r", "code_pack",
           "normal_unit", "normal_unit_group",
           "normal_from_bits", "csr_unit_step", "csr_group_step", "pack_codes",
           "collision_counts", "packed_topk", "packed_topk_masked",
           "packed_collision_counts", "packed_lut_topk",
           "packed_lut_topk_masked", "packed_lut_rerank", "fused_scored_topk",
           "fused_scored_topk_masked", "packed_linear_fwd",
           "packed_linear_fwd_masked", "packed_linear_bwd",
           "packed_linear_bwd_masked", "launch_counts",
           "reset_launch_counts"]

split_r = _proj_code.split_r

# wrapper name -> (module, its launch counter)
_WRAPPERS = {"coded_project": (_proj_code, "launches"),
             "encode_fused": (_encode_fused, "launches"),
             "code_pack": (_encode_fused, "code_pack_launches"),
             "normal_unit": (_normal_unit, "launches"),
             "normal_unit_group": (_normal_unit, "group_launches"),
             "normal_from_bits": (_normal_unit, "bits_launches"),
             "csr_unit_step": (_csr_step, "launches"),
             "csr_group_step": (_csr_step, "group_launches"),
             "pack_codes": (_pack_codes, "launches"),
             "collision_counts": (_collision, "launches"),
             "packed_topk": (_packed_collision, "launches"),
             "packed_topk_masked": (_packed_collision, "masked_launches"),
             "packed_collision_counts": (_packed_collision, "counts_launches"),
             # the tensor-core count sweep inside the four top-k families
             "packed_topk_tc": (_packed_collision, "tc_launches"),
             "packed_lut_topk": (_lut_topk, "launches"),
             "packed_lut_topk_masked": (_lut_topk, "masked_launches"),
             "packed_lut_rerank": (_packed_lut, "launches"),
             "fused_scored_topk": (_fused_scored, "launches"),
             "fused_scored_topk_masked": (_fused_scored, "masked_launches"),
             "packed_linear_fwd": (_packed_linear, "launches"),
             "packed_linear_fwd_masked": (_packed_linear, "masked_launches"),
             "packed_linear_bwd": (_packed_linear, "bwd_launches"),
             "packed_linear_bwd_masked": (_packed_linear,
                                          "bwd_masked_launches")}


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


def _tuned(op: str, dtype: torch.dtype, knobs: dict, **dims) -> dict:
    """Launch knobs for one kernel dispatch: the ones the caller passed
    (not None) win; otherwise the autotune cache's entry for the
    dispatch's shape bucket (``autotune.lookup``, a host dict read), or
    {} for the kernel's defaults."""
    given = {k: v for k, v in knobs.items() if v is not None}
    if given:
        return given
    return _autotune.lookup(op, dtype, **dims)


def _as_f32(q):
    return None if q is None else q.to(torch.float32).contiguous()


def coded_project(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec, q=None,
                  impl: str = "auto", *, r_split=None) -> torch.Tensor:
    """encode(x @ r): float32 [M, D] x float32 or bf16 [D, K] -> int32
    codes [M, K]. ``r_split`` (``split_r(r)``, the kernel's prepared R;
    the plain version ignores it) saves the kernel splitting R for the
    call."""
    _kstats.record("coded_project", m=x.shape[0], d=x.shape[1],
                   k=r.shape[1])
    if _use_kernel(impl, x):
        return _proj_code.coded_project_cuda(x.contiguous(), r.contiguous(),
                                             spec, _as_f32(q),
                                             r_split=r_split)
    return _ref.coded_project_ref(x, r, spec, q)


def encode_fused(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec, q=None,
                 impl: str = "auto", *, r_split=None) -> torch.Tensor:
    """pack(encode(x @ r)): float32 [M, D] x float32 or bf16 [D, K] ->
    int32 words [M, ceil(K*b/32)], the one-kernel ingest path;
    ``r_split`` as for ``coded_project``."""
    _kstats.record("encode_fused", m=x.shape[0], d=x.shape[1], k=r.shape[1],
                   w=_packed_width(r.shape[1], spec.bits))
    if _use_kernel(impl, x):
        return _encode_fused.encode_fused_cuda(x.contiguous(),
                                               r.contiguous(), spec,
                                               _as_f32(q), r_split=r_split)
    return _ref.encode_fused_ref(x, r, spec, q)


def code_pack(z: torch.Tensor, spec: CodeSpec, q=None, impl: str = "auto",
              *, threads: int = None) -> torch.Tensor:
    """pack(encode(z)) of projected float32 or bf16 z [M, K] -> int32
    words [M, ceil(K*b/32)] (the finalize of the streamed and CSR
    regimes)."""
    _kstats.record("code_pack", m=z.shape[0], k=z.shape[1],
                   w=_packed_width(z.shape[1], spec.bits))
    if _use_kernel(impl, z):
        kw = _tuned("code_pack", z.dtype, dict(threads=threads),
                    m=z.shape[0], k=z.shape[1])
        return _encode_fused.code_pack_cuda(z.contiguous(), spec,
                                            _as_f32(q), **kw)
    return _ref.code_pack_ref(z, spec, q)


def normal_unit(key: tuple, width: int, k: int, device,
                impl: str = "auto",
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unit of R under its key (``prng.fold_in(PRNGKey(seed), u)``):
    [width, k] standard normals in ``dtype`` (float32 or bf16) on
    ``device``, bit-identical to ``jax.random.normal``."""
    _kstats.record("normal_unit", m=width, k=k)
    device = torch.device(device)
    if _kernel_on(impl, device):
        return _normal_unit.normal_unit_cuda(key, width, k, device, dtype)
    return _prng.normal(key, (width, k), device, dtype=dtype)


def normal_unit_group(keys: list, widths: list, out: torch.Tensor,
                      slots: list, impl: str = "auto") -> torch.Tensor:
    """Units of R under their keys, in one launch: unit j
    ([widths[j], k] standard normals, bit-identical to ``normal_unit``
    under ``keys[j]``) into ``out[slots[j], :widths[j]]`` of the float32
    or bf16 buffer out [G, r_unit, k] (at most 16 units); the rest of
    out is left as it is -> out."""
    _kstats.record("normal_unit_group", m=sum(widths), k=out.shape[2])
    if _use_kernel(impl, out):
        return _normal_unit.normal_unit_group_cuda(keys, widths, slots, out)
    for key, width, slot in zip(keys, widths, slots):
        out[slot, :width] = _prng.normal(key, (width, out.shape[2]),
                                         out.device, dtype=out.dtype)
    return out


def normal_from_bits(bits: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """int32 bit-views of uint32 bits -> the float32 normals that
    ``jax.random.normal`` makes of them (the draw's last stage)."""
    _kstats.record("normal_from_bits", m=bits.numel(), k=1)
    if _use_kernel(impl, bits):
        return _normal_unit.normal_from_bits_cuda(bits.contiguous())
    return _prng.normal_from_bits(bits.to(torch.int64) & 0xFFFFFFFF)


def csr_unit_step(acc: torch.Tensor, indptr: torch.Tensor,
                  indices: torch.Tensor, data: torch.Tensor, r: torch.Tensor,
                  lo: int, impl: str = "auto", *, nnz: int = None
                  ) -> torch.Tensor:
    """One unit's CSR step, in place: acc[row] += val * r[col - lo] for
    each entry with its column in [lo, lo + r.shape[0]), a row's entries
    in CSR order (rows without such an entry untouched) -> acc. r is
    float32 or bf16. ``nnz``, the unit's entries, is for the kernel
    stats (default: every entry, all of which the kernel scans)."""
    _kstats.record("csr_unit_step", m=acc.shape[0], k=acc.shape[1],
                   nnz=indices.numel() if nnz is None else nnz,
                   span=r.shape[0], rb=r.element_size())
    if _use_kernel(impl, acc):
        return _csr_step.csr_unit_step_cuda(acc, indptr, indices, data,
                                            r.contiguous(), lo)
    return _ref.csr_unit_step_ref(acc, indptr, indices, data, r, lo)


def csr_group_step(acc: torch.Tensor, indptr: torch.Tensor,
                   indices: torch.Tensor, data: torch.Tensor,
                   r: torch.Tensor, lo: int, span: int, impl: str = "auto",
                   *, nnz: int = None) -> torch.Tensor:
    """The CSR step of a group of units in one launch, in place: unit g
    of r float32 or bf16 [G, r_unit, k] covers the columns [lo + g *
    r_unit, lo + (g + 1) * r_unit) of [lo, lo + span), and acc equals
    ``csr_unit_step`` over the units in ascending order, bit for bit ->
    acc. ``nnz``, the group's entries, is for the kernel stats
    (default: every entry)."""
    _kstats.record("csr_group_step", m=acc.shape[0], k=acc.shape[1],
                   nnz=indices.numel() if nnz is None else nnz, span=span,
                   rb=r.element_size())
    if _use_kernel(impl, acc):
        return _csr_step.csr_group_step_cuda(acc, indptr, indices, data,
                                             r.contiguous(), lo, span)
    return _ref.csr_group_step_ref(acc, indptr, indices, data, r, lo, span)


def pack_codes(codes: torch.Tensor, bits: int, impl: str = "auto", *,
               threads: int = None) -> torch.Tensor:
    """int32 codes [M, K] -> int32 words [M, ceil(K*b/32)]."""
    _kstats.record("pack_codes", m=codes.shape[0], k=codes.shape[1],
                   w=_packed_width(codes.shape[1], bits))
    if _use_kernel(impl, codes):
        kw = _tuned("pack_codes", codes.dtype, dict(threads=threads),
                    m=codes.shape[0], k=codes.shape[1])
        return _pack_codes.pack_codes_cuda(codes.contiguous(), bits, **kw)
    return _ref.pack_codes_ref(codes, bits)


def collision_counts(codes_q: torch.Tensor, codes_db: torch.Tensor,
                     impl: str = "auto", *, block_q: int = None,
                     block_n: int = None) -> torch.Tensor:
    """All-pairs collision counts on unpacked int32 codes of any value:
    [Q, K] x [N, K] -> int32 [Q, N]."""
    _kstats.record("collision_counts", q=codes_q.shape[0],
                   n=codes_db.shape[0], k=codes_q.shape[1])
    if _use_kernel(impl, codes_q):
        kw = _tuned("collision_counts", codes_q.dtype,
                    dict(block_q=block_q, block_n=block_n),
                    q=codes_q.shape[0], n=codes_db.shape[0])
        return _collision.collision_counts_cuda(codes_q.contiguous(),
                                                codes_db.contiguous(), **kw)
    return _ref.collision_counts_ref(codes_q, codes_db)


def packed_topk(words_q: torch.Tensor, words_db: torch.Tensor, bits: int,
                k: int, top_k: int, impl: str = "auto", *,
                n_ranges: int = None):
    """Exact top-k by collision count -> (counts, ids) int32 [Q, top_k]."""
    _kstats.record("packed_topk", q=words_q.shape[0], n=words_db.shape[0],
                   w=words_q.shape[1], top_k=top_k)
    if _use_kernel(impl, words_q):
        kw = _tuned("packed_topk", words_q.dtype, dict(n_ranges=n_ranges),
                    q=words_q.shape[0], n=words_db.shape[0],
                    w=words_q.shape[1], top_k=top_k)
        return _packed_collision.packed_topk_cuda(
            words_q.contiguous(), words_db.contiguous(), bits, k, top_k, **kw)
    return _ref.packed_topk_ref(words_q, words_db, bits, k, top_k)


def packed_topk_masked(words_q: torch.Tensor, words_db: torch.Tensor,
                       valid_words: torch.Tensor, bits: int, k: int,
                       top_k: int, impl: str = "auto", *,
                       n_ranges: int = None):
    """Exact top-k over the live rows of ``valid_words`` int32
    [ceil(N/32)] (bit r % 32 of word r // 32 = row r) -> (counts, ids)
    int32 [Q, top_k]; slots past the live count are (-1, -1)."""
    _kstats.record("packed_topk_masked", q=words_q.shape[0],
                   n=words_db.shape[0], w=words_q.shape[1], top_k=top_k)
    if _use_kernel(impl, words_q):
        kw = _tuned("packed_topk_masked", words_q.dtype,
                    dict(n_ranges=n_ranges), q=words_q.shape[0],
                    n=words_db.shape[0], w=words_q.shape[1], top_k=top_k)
        return _packed_collision.packed_topk_masked_cuda(
            words_q.contiguous(), words_db.contiguous(),
            valid_words.contiguous(), bits, k, top_k, **kw)
    return _ref.packed_topk_masked_ref(words_q, words_db, valid_words, bits,
                                       k, top_k)


def packed_collision_counts(words_q: torch.Tensor, words_db: torch.Tensor,
                            bits: int, k: int, impl: str = "auto", *,
                            block_q: int = None) -> torch.Tensor:
    """All-pairs collision counts: int32 words [Q, W] x [N, W] -> int32
    [Q, N]."""
    _kstats.record("packed_collision_counts", q=words_q.shape[0],
                   n=words_db.shape[0], w=words_q.shape[1])
    if _use_kernel(impl, words_q):
        kw = _tuned("packed_collision_counts", words_q.dtype,
                    dict(block_q=block_q), q=words_q.shape[0],
                    n=words_db.shape[0], w=words_q.shape[1])
        return _packed_collision.packed_collision_counts_cuda(
            words_q.contiguous(), words_db.contiguous(), bits, k, **kw)
    return _ref.packed_collision_ref(words_q, words_db, bits, k)


def packed_lut_topk(q_tables: torch.Tensor, words_db: torch.Tensor,
                    bits: int, top_k: int, impl: str = "auto", *,
                    n_ranges: int = None, block_q: int = None):
    """LUT-scored streaming top-k over the whole corpus: float32 or bf16
    tables [Q, F*P] x int32 words [N, W] -> (scores float32, ids int32)
    [Q, top_k], ties to the lowest id, (-inf, -1) in empty slots. The
    knobs are ``lut_topk.plan``'s."""
    t = q_tables.shape[1]
    _kstats.record("packed_lut_topk", q=q_tables.shape[0],
                   n=words_db.shape[0], w=words_db.shape[1], t=t,
                   k=t >> bits, top_k=top_k)
    if _use_kernel(impl, words_db):
        kw = _tuned("packed_lut_topk", q_tables.dtype,
                    dict(n_ranges=n_ranges, block_q=block_q),
                    q=q_tables.shape[0],
                    n=words_db.shape[0], w=words_db.shape[1], t=t,
                    top_k=top_k)
        return _lut_topk.packed_lut_topk_cuda(
            q_tables.contiguous(), words_db.contiguous(), bits, top_k, **kw)
    return _ref.packed_lut_topk_ref(q_tables, words_db, bits, top_k)


def packed_lut_topk_masked(q_tables: torch.Tensor, words_db: torch.Tensor,
                           valid_words: torch.Tensor, bits: int, top_k: int,
                           impl: str = "auto", *, n_ranges: int = None,
                           block_q: int = None):
    """``packed_lut_topk`` over the live rows of ``valid_words`` int32
    [ceil(N/32)]: dead rows score -inf and never surface."""
    t = q_tables.shape[1]
    _kstats.record("packed_lut_topk_masked", q=q_tables.shape[0],
                   n=words_db.shape[0], w=words_db.shape[1], t=t,
                   k=t >> bits, top_k=top_k)
    if _use_kernel(impl, words_db):
        kw = _tuned("packed_lut_topk_masked", q_tables.dtype,
                    dict(n_ranges=n_ranges, block_q=block_q),
                    q=q_tables.shape[0],
                    n=words_db.shape[0], w=words_db.shape[1], t=t,
                    top_k=top_k)
        return _lut_topk.packed_lut_topk_masked_cuda(
            q_tables.contiguous(), words_db.contiguous(),
            valid_words.contiguous(), bits, top_k, **kw)
    return _ref.packed_lut_topk_masked_ref(q_tables, words_db, valid_words,
                                           bits, top_k)


def packed_lut_rerank(q_tables: torch.Tensor, cand_words: torch.Tensor,
                      cand_valid: torch.Tensor, bits: int, top_k: int,
                      impl: str = "auto"):
    """Re-rank gathered candidates [Q, M, W] by per-query LUT score ->
    (scores float32, candidate positions int32) [Q, top_k]."""
    t = q_tables.shape[1]
    _kstats.record("packed_lut_rerank", q=q_tables.shape[0],
                   c=cand_words.shape[1], w=cand_words.shape[2], t=t,
                   k=t >> bits, top_k=top_k)
    if _use_kernel(impl, cand_words):
        return _packed_lut.packed_lut_rerank_cuda(
            q_tables.contiguous(), cand_words.contiguous(),
            (cand_valid != 0).contiguous(), bits, top_k)
    return _ref.packed_lut_rerank_ref(q_tables, cand_words, cand_valid, bits,
                                      top_k)


def fused_scored_topk(q_words: torch.Tensor, q_tables: torch.Tensor,
                      words_db: torch.Tensor, bits: int, k: int,
                      rerank_m: int, top_k: int, scales=None,
                      impl: str = "auto", *, n_ranges: int = None):
    """Top-``top_k`` by LUT score over the stable top-``rerank_m`` by
    collision count -> (scores float32, corpus ids int32) [Q, top_k].
    ``scales`` float32 [Q, W] (powers of two) selects the int8 tables."""
    t = q_tables.shape[1]
    _kstats.record("fused_scored_topk", q=q_words.shape[0],
                   n=words_db.shape[0], w=q_words.shape[1], t=t,
                   k=t >> bits, top_k=top_k)
    if _use_kernel(impl, q_words):
        kw = _tuned("fused_scored_topk", q_tables.dtype,
                    dict(n_ranges=n_ranges), q=q_words.shape[0],
                    n=words_db.shape[0], w=q_words.shape[1], t=t,
                    top_k=top_k)
        return _fused_scored.fused_scored_topk_cuda(
            q_words.contiguous(), q_tables.contiguous(),
            words_db.contiguous(), bits, k, rerank_m, top_k,
            None if scales is None else scales.contiguous(), **kw)
    return _ref.fused_scored_topk_ref(q_words, q_tables, words_db, bits, k,
                                      rerank_m, top_k, scales=scales)


def fused_scored_topk_masked(q_words: torch.Tensor, q_tables: torch.Tensor,
                             words_db: torch.Tensor, valid_words: torch.Tensor,
                             bits: int, k: int, rerank_m: int, top_k: int,
                             scales=None, impl: str = "auto", *,
                             n_ranges: int = None):
    """``fused_scored_topk`` over the live rows of ``valid_words`` int32
    [ceil(N/32)]: dead rows take count -1 before the survivor rule."""
    t = q_tables.shape[1]
    _kstats.record("fused_scored_topk_masked", q=q_words.shape[0],
                   n=words_db.shape[0], w=q_words.shape[1], t=t,
                   k=t >> bits, top_k=top_k)
    if _use_kernel(impl, q_words):
        kw = _tuned("fused_scored_topk_masked", q_tables.dtype,
                    dict(n_ranges=n_ranges), q=q_words.shape[0],
                    n=words_db.shape[0], w=q_words.shape[1], t=t,
                    top_k=top_k)
        return _fused_scored.fused_scored_topk_masked_cuda(
            q_words.contiguous(), q_tables.contiguous(),
            words_db.contiguous(), valid_words.contiguous(), bits, k,
            rerank_m, top_k, None if scales is None else scales.contiguous(),
            **kw)
    return _ref.fused_scored_topk_masked_ref(q_words, q_tables, words_db,
                                             valid_words, bits, k, rerank_m,
                                             top_k, scales=scales)


def _linear_dims(tables_or_g: torch.Tensor, words: torch.Tensor, bits: int,
                 fwd: bool) -> dict:
    c, n, w = tables_or_g.shape[0], words.shape[0], words.shape[1]
    if fwd:
        t = tables_or_g.shape[1]
        return dict(c=c, n=n, w=w, t=t, k=t >> bits)
    f = w * (32 // bits)
    return dict(c=c, n=n, w=w, t=f << bits, k=f)


def packed_linear_fwd(tables: torch.Tensor, words: torch.Tensor, bits: int,
                      impl: str = "auto") -> torch.Tensor:
    """Packed-linear margins: class weight tables float [C, F*P] x int32
    words [N, W] -> float32 [C, N] (the learn forward)."""
    _kstats.record("packed_linear_fwd",
                   **_linear_dims(tables, words, bits, True))
    if _use_kernel(impl, words):
        return _packed_linear.packed_linear_fwd_cuda(
            tables.to(torch.float32).contiguous(), words.contiguous(), bits)
    return _ref.packed_linear_fwd_ref(tables, words, bits)


def packed_linear_fwd_masked(tables: torch.Tensor, words: torch.Tensor,
                             valid_words: torch.Tensor, bits: int,
                             impl: str = "auto") -> torch.Tensor:
    """Packed-linear margins over the live rows of ``valid_words`` int32
    [ceil(N/32)]; dead rows emit 0.0."""
    _kstats.record("packed_linear_fwd_masked",
                   **_linear_dims(tables, words, bits, True))
    if _use_kernel(impl, words):
        return _packed_linear.packed_linear_fwd_cuda(
            tables.to(torch.float32).contiguous(), words.contiguous(), bits,
            valid_words=valid_words.contiguous())
    return _ref.packed_linear_fwd_masked_ref(tables, words, valid_words, bits)


def packed_linear_bwd(g: torch.Tensor, words: torch.Tensor, bits: int,
                      impl: str = "auto", *,
                      block_n: int = 512) -> torch.Tensor:
    """Weight-table gradients: margin gradients float32 [C, N] x int32
    words [N, W] -> float32 [C, F*P] (the learn backward), summed in
    ``block_n``-row chunks in the order of ``ref.packed_linear_bwd_ref``
    (the reference's ``block_c`` tiles classes and changes no number;
    the port has none). ``block_n`` fixes the sum order, so the
    autotuner never sweeps it."""
    _kstats.record("packed_linear_bwd", **_linear_dims(g, words, bits, False))
    if _use_kernel(impl, words):
        return _packed_linear.packed_linear_bwd_cuda(
            g.to(torch.float32).contiguous(), words.contiguous(), bits,
            block_n=block_n)
    return _ref.packed_linear_bwd_ref(g, words, bits, block_n=block_n)


def packed_linear_bwd_masked(g: torch.Tensor, words: torch.Tensor,
                             valid_words: torch.Tensor, bits: int,
                             impl: str = "auto", *,
                             block_n: int = 512) -> torch.Tensor:
    """Weight-table gradients over the live rows of ``valid_words``: dead
    rows contribute nothing."""
    _kstats.record("packed_linear_bwd_masked",
                   **_linear_dims(g, words, bits, False))
    if _use_kernel(impl, words):
        return _packed_linear.packed_linear_bwd_cuda(
            g.to(torch.float32).contiguous(), words.contiguous(), bits,
            block_n=block_n, valid_words=valid_words.contiguous())
    return _ref.packed_linear_bwd_masked_ref(g, words, valid_words, bits,
                                             block_n=block_n)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Sets every wrapper's launch count to 0."""
    for mod, attr in _WRAPPERS.values():
        setattr(mod, attr, 0)
