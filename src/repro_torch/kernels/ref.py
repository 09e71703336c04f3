"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py:30-330, 333-547``).

They define the semantics the CUDA kernels are held to on the card, and
they are what ``ops`` runs for tensors on the CPU. Integer outputs are
bit-exact against the JAX oracles; the projections follow
``torch.matmul``'s float32 sum order. LUT scores add float32 table
entries one by one in (word, field) order, and every top-k is a stable
sort: ties go to the lowest index, as ``lax.top_k`` gives them. The
packed-linear backward adds in an order it defines in full (chunk
partials folded in chunk order), so its kernel is bit-exact against it
and training is deterministic.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing as _packing
from repro_torch.core import schemes as _schemes
from repro_torch.core.schemes import CodeSpec

__all__ = ["coded_project_ref", "tf32_split", "pack_codes_ref",
           "encode_fused_ref",
           "code_pack_ref", "csr_unit_step_ref", "csr_group_step_ref",
           "collision_counts_ref",
           "packed_collision_ref", "topk_stable_ref", "packed_topk_ref",
           "packed_topk_masked_ref", "onehot_counts_ref",
           "packed_topk_partial_ref", "lut_scores_rowwise_ref", "lut_scores_rowwise_int8_ref",
           "topk_scored_ref", "packed_lut_topk_ref",
           "packed_lut_topk_masked_ref", "packed_lut_rerank_ref",
           "coarse_survivor_mask_ref", "fused_scored_topk_ref",
           "fused_scored_topk_masked_ref", "two_stage_scored_ref",
           "two_stage_scored_masked_ref", "onehot_rows",
           "packed_linear_fwd_ref", "packed_linear_fwd_masked_ref",
           "packed_linear_bwd_ref", "packed_linear_bwd_masked_ref"]


def coded_project_ref(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                      q=None) -> torch.Tensor:
    """x [M, D] @ r [D, K] in float32 -> int32 codes [M, K] (a bf16 r
    widens exactly, as the reference's float32-preferred dot does)."""
    return _schemes.encode(torch.matmul(x, r.to(torch.float32)), spec, q)


def _rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero, as float32
    (``cvt.rna.tf32.f32``): the low 13 mantissa bits rounded off on the
    int32 view of a finite value."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """float32 or bf16 t -> (hi, lo), float32 with TF32 values: hi =
    rna_tf32(t), lo = rna_tf32(t - hi), ``t - hi`` exact. The GEMM
    kernels take x @ r as lo_x @ hi_r + hi_x @ lo_r + hi_x @ hi_r; a
    bf16 t is exact in TF32, so its lo is zero. Preparation of an
    operand, not a kernel."""
    t = t.to(torch.float32)
    hi = _rna_tf32(t)
    return hi, _rna_tf32(t - hi)


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """int codes [M, K] -> int32 words [M, ceil(K*bits/32)]."""
    return _packing.pack_codes(codes, bits)


def encode_fused_ref(x: torch.Tensor, r: torch.Tensor, spec: CodeSpec,
                     q=None) -> torch.Tensor:
    """x [M, D] @ r [D, K] -> packed int32 words [M, ceil(K*b/32)]."""
    return _packing.pack_codes(coded_project_ref(x, r, spec, q), spec.bits)


def code_pack_ref(z: torch.Tensor, spec: CodeSpec, q=None) -> torch.Tensor:
    """Projected z [M, K] -> packed int32 words [M, ceil(K*b/32)]: the
    coding scheme, then the b-bit pack (fields past K zero)."""
    return _packing.pack_codes(
        _schemes.encode(z.to(torch.float32), spec, q), spec.bits)


def csr_unit_step_ref(acc: torch.Tensor, indptr: torch.Tensor,
                      indices: torch.Tensor, data: torch.Tensor,
                      r: torch.Tensor, lo: int) -> torch.Tensor:
    """One unit's CSR step, in place on acc float32 [n, k]: each entry
    whose column lies in [lo, lo + r.shape[0]) adds its rounded product
    val * r[col - lo] (r float32 or bf16, widened exactly) to acc[row],
    a row's entries in CSR order (the order of XLA's scatter-add in the
    reference). Rows without such an entry are left as they are.

    Selecting the unit's entries keeps CSR order, so each row's entries
    form one run; the loop over the position j within a run adds one
    product to every run's row at once, so the sum order is fixed on any
    device."""
    lcol = indices - lo
    sel = torch.nonzero((lcol >= 0) & (lcol < r.shape[0])).flatten()
    if sel.numel() == 0:
        return acc
    rows = torch.searchsorted(indptr, sel, right=True) - 1
    prods = data[sel, None] * r[lcol[sel].long()].to(torch.float32)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    starts = torch.nonzero(first).flatten()
    pos = torch.arange(sel.numel(), device=sel.device) - \
        starts[torch.cumsum(first, 0) - 1]
    for j in range(int(pos.max()) + 1):
        at = pos == j
        acc[rows[at]] = acc[rows[at]] + prods[at]
    return acc


def csr_group_step_ref(acc: torch.Tensor, indptr: torch.Tensor,
                       indices: torch.Tensor, data: torch.Tensor,
                       r: torch.Tensor, lo: int, span: int) -> torch.Tensor:
    """The CSR step of a group of units, in place on acc float32 [n, k]:
    unit g of r [G, r_unit, k] (float32 or bf16, widened exactly) covers
    the columns [lo + g * r_unit, lo + (g + 1) * r_unit) of [lo, lo +
    span), and the units take ``csr_unit_step_ref`` in ascending order,
    so a row's entries of a lower unit are added before those of a
    higher one, whatever their CSR positions."""
    ru = r.shape[1]
    for g in range(r.shape[0]):
        width = min(ru, span - g * ru)
        if width > 0:
            csr_unit_step_ref(acc, indptr, indices, data, r[g, :width],
                              lo + g * ru)
    return acc


def collision_counts_ref(codes_q: torch.Tensor, codes_db: torch.Tensor,
                         block_elems: int = 1 << 26) -> torch.Tensor:
    """int32 codes [Q, K] x [N, K], any values -> int32 [Q, N] counts of
    equal positions, over column blocks of at most ``block_elems``
    (query, row, position) triples, so [Q, N, K] is never built."""
    nq, k = codes_q.shape
    n = codes_db.shape[0]
    out = torch.empty((nq, n), dtype=torch.int32, device=codes_q.device)
    step = max(1, block_elems // max(nq * k, 1))
    for lo in range(0, n, step):
        eq = codes_q[:, None, :] == codes_db[None, lo:lo + step, :]
        out[:, lo:lo + step] = eq.sum(dim=2, dtype=torch.int32)
    return out


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


def onehot_counts_ref(words_q: torch.Tensor, words_db: torch.Tensor,
                      bits: int, k: int) -> torch.Tensor:
    """``packed_collision_ref`` by the tensor-core sweep's arithmetic
    (``csrc/topk_tc.cuh``): count = k - F + onehot(q) . onehot(db), over
    every one of the F = 32W/b field slots (padding included), as an
    exact float64 product -> int32 [Q, N]."""
    f = words_q.shape[1] * (32 // bits)
    hits = onehot_rows(words_q, bits, torch.float64) @ \
        onehot_rows(words_db, bits, torch.float64).T
    return (k - f + hits).to(torch.int32)


def packed_topk_partial_ref(words_q: torch.Tensor, words_db: torch.Tensor,
                            valid_words, bits: int, k: int, top_k: int,
                            n_ranges: int):
    """The count sweep's partial lists (the kernels' scratch before the
    merge): per query, the stable top-k of each of ``n_ranges``
    contiguous ranges of ceil(N / n_ranges) rows -> (counts, ids) int32
    [n_ranges, Q, top_k]. An entry must beat -1: dead rows (when
    ``valid_words`` is given) and negative counts come back (-1, -1)."""
    counts = packed_collision_ref(words_q, words_db, bits, k)
    if valid_words is not None:
        counts = _kill_dead(counts, valid_words)
    counts = counts.clamp(min=-1)
    n, rows = counts.shape[1], -(-counts.shape[1] // n_ranges)
    vals, ids = [], []
    for s in range(n_ranges):
        lo = min(n, s * rows)
        v, i = topk_stable_ref(counts[:, lo:min(n, lo + rows)], top_k)
        vals.append(v)
        ids.append(torch.where(i >= 0, i + lo, i))
    return torch.stack(vals), torch.stack(ids)


def _kill_dead(counts: torch.Tensor, valid_words: torch.Tensor) -> torch.Tensor:
    """Counts [Q, N] with the rows whose validity bit is clear set to -1
    (``valid_words``: int32 [ceil(N/32)], bit r % 32 of word r // 32)."""
    live = _packing.unpack_bitmask(valid_words, counts.shape[1])
    return torch.where(live[None, :], counts, torch.full_like(counts, -1))


def packed_topk_masked_ref(words_q: torch.Tensor, words_db: torch.Tensor,
                           valid_words: torch.Tensor, bits: int, k: int,
                           top_k: int):
    """``packed_topk_ref`` over live rows only: dead rows take count -1,
    so they never surface, and slots past the live count are (-1, -1)."""
    return topk_stable_ref(_kill_dead(packed_collision_ref(
        words_q, words_db, bits, k), valid_words), top_k)


# -- LUT-scored ranking -------------------------------------------------------

def lut_scores_rowwise_ref(q_tables: torch.Tensor, cand_words: torch.Tensor,
                           bits: int) -> torch.Tensor:
    """Float tables [Q, F*P] x per-query candidate words [Q, M, W] ->
    float32 scores [Q, M]: one float32 add per field, in (word, field)
    order, of the entry the field's code selects. Words [M, W] are one
    candidate list shared by every query (a corpus): each field is then
    decoded once for all queries, with the same adds."""
    p, cpw = 1 << bits, 32 // bits
    n_words = cand_words.shape[-1]
    if q_tables.shape[-1] != n_words * cpw * p:
        raise ValueError(f"tables {tuple(q_tables.shape)} do not fit words "
                         f"{tuple(cand_words.shape)} at bits={bits}")
    shared = cand_words.dim() == 2
    tab, u = q_tables.to(torch.float32), _packing.as_u32(cand_words)
    shape = (q_tables.shape[0], cand_words.shape[0]) if shared \
        else cand_words.shape[:-1]
    score = torch.zeros(shape, dtype=torch.float32,
                        device=cand_words.device)
    for w in range(n_words):
        for f in range(cpw):
            c = (u[..., w] >> (f * bits)) & (p - 1)
            part = tab[:, (w * cpw + f) * p:(w * cpw + f + 1) * p]
            score = score + (part[:, c] if shared
                             else torch.gather(part, 1, c))
    return score


def lut_scores_rowwise_int8_ref(q_tables: torch.Tensor, scales: torch.Tensor,
                                cand_words: torch.Tensor,
                                bits: int) -> torch.Tensor:
    """int8 tables [Q, F*P] with float32 scales [Q, W] -> float32 [Q, M]:
    each word's 32/b entries sum exactly in int32, then the word joins
    the total as ``score + scale[w] * float(isum)`` (a multiply and an
    add, each rounded), in word order."""
    p, cpw = 1 << bits, 32 // bits
    n_words = cand_words.shape[-1]
    if q_tables.shape[-1] != n_words * cpw * p or \
            tuple(scales.shape) != (q_tables.shape[0], n_words):
        raise ValueError(f"tables {tuple(q_tables.shape)}, scales "
                         f"{tuple(scales.shape)} do not fit words "
                         f"{tuple(cand_words.shape)} at bits={bits}")
    tab, u = q_tables.to(torch.int32), _packing.as_u32(cand_words)
    score = torch.zeros(cand_words.shape[:-1], dtype=torch.float32,
                        device=cand_words.device)
    for w in range(n_words):
        isum = torch.zeros_like(score, dtype=torch.int32)
        for f in range(cpw):
            c = (u[..., w] >> (f * bits)) & (p - 1)
            col = (w * cpw + f) * p
            isum = isum + torch.gather(tab[:, col:col + p], 1, c)
        score = score + scales[:, w:w + 1] * isum.to(torch.float32)
    return score


def topk_scored_ref(scores: torch.Tensor, top_k: int):
    """Stable descending top-k of float scores [c, n] -> (float32
    [c, top_k], int32 ids [c, top_k]); -inf slots, and slots past n,
    are (-inf, -1)."""
    scores = scores.to(torch.float32)
    if top_k > scores.shape[1]:
        scores = torch.nn.functional.pad(scores,
                                         (0, top_k - scores.shape[1]),
                                         value=float("-inf"))
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, ids = vals[:, :top_k], ids[:, :top_k].to(torch.int32)
    return vals, torch.where(torch.isneginf(vals), torch.full_like(ids, -1),
                             ids)


def _lut_topk_blocked(q_tables: torch.Tensor, words_db: torch.Tensor,
                      live, bits: int, top_k: int, block_elems: int):
    """Stable top-k by LUT score over the corpus, a column block at a
    time: each block's rows are scored (``lut_scores_rowwise_ref`` on the
    block's words, one list shared by every query), rows not ``live`` at
    -inf, and merged into the running list by a stable sort of [running,
    block]; running entries have the lower ids, so ties keep them."""
    nq, n = q_tables.shape[0], words_db.shape[0]
    dev = words_db.device
    best_v = torch.full((nq, 0), float("-inf"), dtype=torch.float32,
                        device=dev)
    best_i = torch.full((nq, 0), -1, dtype=torch.int32, device=dev)
    step = max(1, block_elems // max(nq, 1))
    for lo in range(0, n, step):
        blk = words_db[lo:lo + step]
        sc = lut_scores_rowwise_ref(q_tables, blk, bits)
        if live is not None:
            sc = torch.where(live[None, lo:lo + step], sc,
                             torch.full_like(sc, float("-inf")))
        ids = torch.arange(lo, lo + blk.shape[0], dtype=torch.int32,
                           device=dev).expand(nq, -1)
        vals, pos = topk_scored_ref(torch.cat([best_v, sc], dim=1), top_k)
        cat_i = torch.cat([best_i, ids], dim=1)
        best_i = torch.gather(cat_i, 1, pos.clamp(min=0).to(torch.int64))
        best_i = torch.where(pos < 0, torch.full_like(best_i, -1), best_i)
        best_v = vals
    if n == 0:
        return topk_scored_ref(best_v, top_k)
    return best_v, best_i


def packed_lut_topk_ref(q_tables: torch.Tensor, words_db: torch.Tensor,
                        bits: int, top_k: int, block_elems: int = 1 << 24):
    """Full-corpus LUT-scored search: float tables [Q, F*P] x int32 words
    [N, W] -> (scores float32, ids int32) [Q, top_k]: each row's score in
    (word, field) order, the stable top-k (ties to the lowest id), empty
    slots (-inf, -1). Column blocks of ``block_elems`` scores bound the
    memory; [Q, N] is never built."""
    return _lut_topk_blocked(q_tables, words_db, None, bits, top_k,
                             block_elems)


def packed_lut_topk_masked_ref(q_tables: torch.Tensor, words_db: torch.Tensor,
                               valid_words: torch.Tensor, bits: int,
                               top_k: int, block_elems: int = 1 << 24):
    """``packed_lut_topk_ref`` over the live rows of ``valid_words`` int32
    [ceil(N/32)]: dead rows score -inf and never surface."""
    live = _packing.unpack_bitmask(valid_words, words_db.shape[0])
    return _lut_topk_blocked(q_tables, words_db, live, bits, top_k,
                             block_elems)


def packed_lut_rerank_ref(q_tables: torch.Tensor, cand_words: torch.Tensor,
                          cand_valid: torch.Tensor, bits: int, top_k: int):
    """Re-rank per-query candidates [Q, M, W] by LUT score -> (scores
    float32, candidate positions int32) [Q, top_k]; invalid candidates
    score -inf, empty slots are (-inf, -1)."""
    scores = lut_scores_rowwise_ref(q_tables, cand_words, bits)
    scores = torch.where(cand_valid != 0, scores,
                         torch.full_like(scores, float("-inf")))
    return topk_scored_ref(scores, top_k)


def coarse_survivor_mask_ref(counts: torch.Tensor, k: int,
                             rerank_m: int) -> torch.Tensor:
    """Membership mask [Q, N] of the stable top-``rerank_m`` by collision
    count: with t the smallest c in [0, k] such that fewer than rerank_m
    rows have count > c (a binary search), a row survives if its count
    is above t, or equals t and its id-ascending rank among those ties
    is within the quota rerank_m - #{count > t}. Rows with count < 0
    never survive."""
    q = counts.shape[0]
    lo = torch.zeros((q, 1), dtype=torch.int32, device=counts.device)
    hi = torch.full((q, 1), k, dtype=torch.int32, device=counts.device)
    for _ in range(max(1, (k + 1).bit_length())):
        mid = (lo + hi) >> 1
        done = (counts > mid).sum(dim=1, keepdim=True) < rerank_m
        lo = torch.where(done, lo, mid + 1)
        hi = torch.where(done, mid, hi)
    quota = rerank_m - (counts > lo).sum(dim=1, keepdim=True)
    is_tie = counts == lo
    tie_rank = torch.cumsum(is_tie.to(torch.int32), dim=1, dtype=torch.int32)
    return (counts > lo) | (is_tie & (tie_rank <= quota))


def _compact_survivors(sm: torch.Tensor, rerank_m: int) -> torch.Tensor:
    """Survivor mask [Q, N] -> id-ascending survivor ids [Q, rerank_m],
    -1 padded: the j-th survivor is where the mask's running sum first
    reaches j + 1."""
    csum = torch.cumsum(sm.to(torch.int32), dim=1, dtype=torch.int32)
    targets = torch.arange(1, rerank_m + 1, dtype=torch.int32,
                           device=sm.device).expand(sm.shape[0], rerank_m)
    pos = torch.searchsorted(csum, targets.contiguous(), side="left")
    found = targets <= csum[:, -1:]
    return torch.where(found, pos.to(torch.int32),
                       torch.full_like(targets, -1))


def _score_candidates(q_tables, words_db, cand, bits: int, top_k: int,
                      scales):
    """LUT-score candidate ids [Q, m] (-1 = empty, scores -inf) and take
    the stable top-k -> (scores, corpus ids)."""
    n, m = words_db.shape[0], cand.shape[1]
    cand_words = words_db[cand.clamp(0, n - 1).to(torch.int64)]
    if scales is None:
        s = lut_scores_rowwise_ref(q_tables, cand_words, bits)
    else:
        s = lut_scores_rowwise_int8_ref(q_tables, scales, cand_words, bits)
    s = torch.where(cand >= 0, s, torch.full_like(s, float("-inf")))
    vals, pos = topk_scored_ref(s, top_k)
    ids = torch.gather(cand, 1, pos.clamp(0, m - 1).to(torch.int64))
    return vals, torch.where(pos < 0, torch.full_like(ids, -1), ids)


def _empty_scored(q: int, top_k: int, device):
    return (torch.full((q, top_k), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.full((q, top_k), -1, dtype=torch.int32, device=device))


def _scored_survivors(counts, q_tables, words_db, bits: int, k: int,
                      rerank_m: int, top_k: int, scales):
    """LUT-score the stable top-``rerank_m`` rows by ``counts`` [Q, N]
    (rows at -1 never survive) -> (scores, corpus ids) [Q, top_k]."""
    cand = _compact_survivors(coarse_survivor_mask_ref(counts, k, rerank_m),
                              rerank_m)
    return _score_candidates(q_tables, words_db, cand, bits, top_k, scales)


def fused_scored_topk_ref(q_words: torch.Tensor, q_tables: torch.Tensor,
                          words_db: torch.Tensor, bits: int, k: int,
                          rerank_m: int, top_k: int, scales=None):
    """Top-``top_k`` by LUT score over the stable top-``rerank_m`` by
    collision count -> (scores float32, corpus ids int32) [Q, top_k];
    score ties go to the lowest id, empty slots are (-inf, -1).
    ``scales`` float32 [Q, W] selects the int8 table path."""
    if words_db.shape[0] == 0:
        return _empty_scored(q_words.shape[0], top_k, q_words.device)
    counts = packed_collision_ref(q_words, words_db, bits, k)
    return _scored_survivors(counts, q_tables, words_db, bits, k, rerank_m,
                             top_k, scales)


def fused_scored_topk_masked_ref(q_words: torch.Tensor,
                                 q_tables: torch.Tensor,
                                 words_db: torch.Tensor,
                                 valid_words: torch.Tensor, bits: int, k: int,
                                 rerank_m: int, top_k: int, scales=None):
    """``fused_scored_topk_ref`` over live rows only: dead rows take
    count -1 before the survivor rule, so they neither survive nor
    displace a live tie; an all-dead corpus gives only (-inf, -1)."""
    if words_db.shape[0] == 0:
        return _empty_scored(q_words.shape[0], top_k, q_words.device)
    counts = _kill_dead(packed_collision_ref(q_words, words_db, bits, k),
                        valid_words)
    return _scored_survivors(counts, q_tables, words_db, bits, k, rerank_m,
                             top_k, scales)


def _rerank_coarse(ci: torch.Tensor, q_tables, words_db, bits: int,
                   top_k: int):
    """Coarse ids [Q, m] (-1 = empty) -> LUT re-rank of their rows ->
    (scores, corpus ids) [Q, top_k]."""
    n, m = words_db.shape[0], ci.shape[1]
    vals, pos = packed_lut_rerank_ref(
        q_tables, words_db[ci.clamp(0, n - 1).to(torch.int64)], ci >= 0,
        bits, top_k)
    ids = torch.gather(ci, 1, pos.clamp(0, m - 1).to(torch.int64))
    return vals, torch.where(pos < 0, torch.full_like(ids, -1), ids)


def two_stage_scored_ref(q_words: torch.Tensor, q_tables: torch.Tensor,
                         words_db: torch.Tensor, bits: int, k: int,
                         rerank_m: int, top_k: int):
    """Coarse ``packed_topk_ref`` to rerank_m, gather, then
    ``packed_lut_rerank_ref``: equal to ``fused_scored_topk_ref``
    wherever LUT scores do not tie across different collision counts."""
    if words_db.shape[0] == 0:
        return _empty_scored(q_words.shape[0], top_k, q_words.device)
    _, ci = packed_topk_ref(q_words, words_db, bits, k, rerank_m)
    return _rerank_coarse(ci, q_tables, words_db, bits, top_k)


def two_stage_scored_masked_ref(q_words: torch.Tensor,
                                q_tables: torch.Tensor,
                                words_db: torch.Tensor,
                                valid_words: torch.Tensor, bits: int, k: int,
                                rerank_m: int, top_k: int):
    """The masked two-stage composition: ``packed_topk_masked_ref`` to
    rerank_m, then the LUT re-rank of the live candidates."""
    if words_db.shape[0] == 0:
        return _empty_scored(q_words.shape[0], top_k, q_words.device)
    _, ci = packed_topk_masked_ref(q_words, words_db, valid_words, bits, k,
                                   rerank_m)
    return _rerank_coarse(ci, q_tables, words_db, bits, top_k)


# -- packed linear classifier (learn) -----------------------------------------

def packed_linear_fwd_ref(tables: torch.Tensor, words_db: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """Margins of a packed linear model: class weight tables float
    [C, F*P] (flat ``learn.features`` layout) x words [N, W] -> float32
    [C, N], ``lut_scores_rowwise_ref`` with one table a class and every
    class's candidates the whole corpus: margin[c, n] adds, in (word,
    field) order from 0.0, the entry each b-bit field of row n selects."""
    return lut_scores_rowwise_ref(
        tables, words_db[None].expand((tables.shape[0],) + words_db.shape),
        bits)


def packed_linear_fwd_masked_ref(tables: torch.Tensor, words_db: torch.Tensor,
                                 valid_words: torch.Tensor,
                                 bits: int) -> torch.Tensor:
    """``packed_linear_fwd_ref`` over the live rows of ``valid_words``
    int32 [ceil(N/32)]: dead rows emit margin 0.0."""
    scores = packed_linear_fwd_ref(tables, words_db, bits)
    live = _packing.unpack_bitmask(valid_words, words_db.shape[0])
    return torch.where(live[None, :], scores, torch.zeros_like(scores))


def onehot_rows(words: torch.Tensor, bits: int,
                dtype=torch.float32) -> torch.Tensor:
    """Dense one-hot of every field slot: words [n, W] -> [n, F*P] of
    ``dtype`` in the flat table layout (phantom field slots included),
    built from ``packing.unpack_codes`` and independent of the kernels:
    entry [n, f*P + v] is 1 iff field f of row n holds code v."""
    p = 1 << bits
    f = words.shape[-1] * (32 // bits)
    codes = _packing.unpack_codes(words, bits, f).to(torch.int64)
    hot = codes[..., None] == torch.arange(p, device=words.device)
    return hot.reshape(words.shape[0], f * p).to(dtype)


def packed_linear_bwd_ref(g: torch.Tensor, words_db: torch.Tensor, bits: int,
                          *, block_n: int = 512) -> torch.Tensor:
    """Weight-table gradients: margin gradients g float32 [C, N] x words
    [N, W] -> float32 [C, F*P], dTables[c, f*P + v] = the sum of g[c, n]
    over the rows n whose field f holds code v.

    The sum order, which the kernel (``csrc/packed_linear.cu``) follows
    bit for bit: rows go in chunks of ``block_n``; within a chunk, each
    row's contribution is added, in ascending row order, onto a partial
    that starts at 0.0; the accumulator starts at 0.0 and the chunks'
    partials are added onto it in chunk order. The reference fixes its
    order only up to XLA's dot inside a chunk (``repro/kernels/ref.py:
    292-319``), so the two agree to float rounding, exactly where every
    partial sum is exact.

    The loop runs over the position i within a chunk: one gather and one
    scatter add row i of every chunk at once, for all classes and fields,
    and no two of those writes reach the same entry.
    """
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    c, n = g.shape
    p, cpw = 1 << bits, 32 // bits
    n_words = words_db.shape[1]
    f = n_words * cpw
    acc = torch.zeros((c, f * p), dtype=torch.float32, device=g.device)
    if n == 0 or c == 0:
        return acc
    nch = -(-n // block_n)
    pad = nch * block_n - n
    gp = torch.nn.functional.pad(g.to(torch.float32), (0, pad)) \
        .reshape(c, nch, block_n)
    wp = torch.nn.functional.pad(_packing.as_u32(words_db), (0, 0, 0, pad)) \
        .reshape(nch, block_n, n_words)
    shifts = torch.arange(cpw, device=g.device) * bits
    part = torch.zeros((nch, c, f, p), dtype=torch.float32, device=g.device)
    for i in range(min(block_n, n)):
        # padded rows of the last chunk carry g = 0.0, and x + 0.0 == x for
        # every partial (a partial that starts at +0.0 is never -0.0)
        codes = ((wp[:, i, :, None] >> shifts) & (p - 1)).reshape(nch, f)
        idx = codes[:, None, :, None].expand(nch, c, f, 1)
        gi = gp[:, :, i].t()[:, :, None, None].expand(nch, c, f, 1)
        part.scatter_(3, idx, part.gather(3, idx) + gi)
    part = part.reshape(nch, c, f * p)
    for ch in range(nch):
        acc = acc + part[ch]
    return acc


def packed_linear_bwd_masked_ref(g: torch.Tensor, words_db: torch.Tensor,
                                 valid_words: torch.Tensor, bits: int, *,
                                 block_n: int = 512) -> torch.Tensor:
    """``packed_linear_bwd_ref`` over the live rows of ``valid_words``:
    dead rows' gradients are zeroed first, so they add exact zeros (the
    kernel skips them, which is the same)."""
    live = _packing.unpack_bitmask(valid_words, words_db.shape[0])
    g = torch.where(live[None, :], g.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=g.device))
    return packed_linear_bwd_ref(g, words_db, bits, block_n=block_n)
