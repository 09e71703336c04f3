#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py            # full run: build, kernel checks, main path
    python3 chip_smoke.py --check    # build and the small-shape kernel checks only
    python3 chip_smoke.py --profile  # full run plus torch.profiler breakdowns

Phases, in order; any failure raises and the script exits non-zero:

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time, the
   compiler's register and spill report, and the card's name and power
   limit.
2. Kernel checks. Small ragged shapes over every scheme, bit width and
   table type (rerank_m above N, top_k above the survivors, all rows
   tied, N = 0; for the masked kernels N = 0, 1, 31, 33 and 3,000 with
   all, none, 10 % and 90 % of the rows dead), then the main path's
   shapes (the masked kernels on one 262,144-row segment and on the
   4,194,304 rows with 10 % dead): each kernel against its
   plain PyTorch version on the same inputs, on the card. Every kernel
   but the two GEMMs must be bit-exact; the GEMMs may differ from
   ``torch.matmul``'s float32 sum order only in fields whose reference
   projection lies within 1e-5 of a bin edge. Each kernel is timed (CUDA
   events, median of 10; 3 for the plain versions that build the whole
   [256, 4,194,304] count matrix) beside its plain version and its bound.
3. Main path at N = 4,194,304 rows, D = 1024, k = 256, 2-bit codes at
   w = 0.75: seeded Gaussian rows made on the card in 65,536-row chunks
   go through ``CodedRandomProjection.sketch`` into a ``CodeStore``;
   ``AnnEngine`` searches 1,024 queries (512 of them noisy corpus rows
   that must come back at rank 0), ``add``s a batch and searches again.
   Launch counts are reset just before and read just after; every kernel
   of the path must have launched. 16 queries are then rechecked against
   the plain ``packed_topk_ref`` over the whole store.
4. Scored and LSH path, on the engine after ``add`` (4,259,840 rows):
   the rank tables are checked against JAX's to a relative 1e-4; scored
   search (fused with f32, then int8 tables, then two-stage) over the
   1,024 queries and LSH search (count-ranked, then scored; 16 bands of
   4 codes, no probes, one band to match) over 256 of them, with launch
   counts reset before and read after. Gates: planted queries at rank 0
   (512/512 scored f32 and two-stage, 128/128 LSH), two-stage equal to
   fused on every query but those whose plain versions differ too
   (LUT scores tied across collision counts; counted), and 16 queries of
   each mode bit-exact against the same engine on the plain versions.
   Printed, not gated: queries/s of each mode, and the rank-0 hit rate
   of count-ranked against scored search on planted queries at cosine
   0.9 and 0.6.
5. Mutable path (``repro_torch.index``): ``MutableAnnEngine`` with
   262,144-row segments ingests the main path's 4,194,304 rows (64
   ``ingest`` calls of 65,536 rows made on the card from its seed; the
   words must equal the main path's store), deletes 419,430 ids (a
   quarter of the planted sources among them), upserts 65,536 ids (64
   planted sources re-planted under their old ids) and adds 65,536
   rows: 17 segments. It then searches in six modes (count-ranked,
   scored fused f32 and int8 and two-stage over the 1,024 queries; LSH
   count-ranked and scored over 256), compacts (target 1,048,576 rows,
   5 % dead), searches again, saves a snapshot, restores it and
   searches again. Launch counts cover the path's own calls. Gates: no
   deleted id comes back; live planted and re-planted sources at rank
   0; count-ranked modes bit-exact against a fresh immutable engine over
   ``live_words()``, and unchanged by compaction; scored modes
   bit-exact against the same search without masks, one segment's live
   rows at a time (the coarse top-m is per segment, so they need not
   equal the whole-store engine; the agreement is printed); 16 queries
   of each mode bit-exact against the plain versions; the restored
   index bit-exact in every mode. Printed: rows/s of ingest, ms and
   rows/s of delete, upsert and add, queries/s per mode at each stage,
   ms of the compaction, MB/s of the snapshot's save and restore.
6. Encode kernels at the URL path's shapes, on chunk 0 of the URL
   corpus: ``code_pack`` (B8) on its [262,144 x 256] projections, the R
   draw of one [4,096 x 256] unit, the CSR step on one unit's bucket
   (with ``torch.addmm`` of the bucket as a sparse CSR tensor as the
   library yardstick); each bit-exact against its plain version, timed
   beside its bound. The small checks (phase 2) hold B8 to its plain
   version over every scheme at ragged shapes, the draw to the CPU's
   ``prng`` on all 2^23 mantissas, on whole units and on URL units 0, 1
   and 789, and the CSR step to its plain version on empty rows, no
   entries, repeated columns and rows in the ragged last unit only.
7. URL path, at the URL corpus's published width: D = 3,231,961 (790
   units of R, the last 217 rows; R, 3.3 GB, is never built), k = 256,
   2-bit codes, 2,396,130 CSR rows of 115 distinct columns made on the
   host chunk by chunk, through ``IngestPipeline`` (262,144-row chunks)
   into a ``CodeStore``; ``AnnEngine`` searches 1,024 CSR queries (512
   planted at cosine about 0.9) count-ranked and scored; then
   ``MutableAnnEngine.ingest`` takes the first 524,288 rows. Launches
   counted over the path. Gates: R never built; each chunk's peak device
   memory beyond the store within its CSR arrays, accumulator and words
   plus 64 MB; 512/512 planted at rank 0 in both modes; 16 rows
   bit-exact against ``impl="ref"`` and against a float64 oracle but at
   counted bin-edge fields; the mutable engine's words equal the store's.
8. Dense cross-check above the cap: 8,192 unit rows at D = 131,072
   (about 1 % nonzero) encoded fused with R resident (cap raised),
   streamed at the default cap and as CSR agree but at bin edges.
9. A ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet; CUDA C Programming
# Guide throughput table for compute capability 9.0 at 132 SMs and the
# 1.98 GHz boost clock: 64 int32 add/logic/shift and 16 popc results per
# SM per clock).
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
INT32_OP_S = 132 * 64 * 1.98e9
POPC_OP_S = 132 * 16 * 1.98e9
SPIN_CYCLES = int(2e-3 * 1.98e9)   # 2 ms at the boost clock

# SHA-256 of the JAX reference's R for SketchConfig() at D = 1024
# (repro.core.sketch.CodedRandomProjection(SketchConfig(), 1024)
#  .stream_encoder().r_matrix(), float32 bytes, row-major).
R_SHA256 = "a7a08cc49a0e89c4387cc9ac787b6f72a52d45fdb94e468ea171f3a24bd96818"

N_ROWS, D, K, CHUNK = 4_194_304, 1024, 256, 65_536
# the URL corpus's published width, rows and nonzeros a row
# (src/repro/encode/sparse.py:3-9; src/repro/encode/encoder.py:48-52)
URL_D, URL_ROWS, URL_NNZ, URL_CHUNK = 3_231_961, 2_396_130, 115, 262_144
URL_SEED, URL_MOVED = 2015, 12    # planted: 12 of 115 nonzeros moved (10 %)
N_QUERIES, N_PLANTED, CHUNK_Q, TOP_K = 1024, 512, 256, 10
RERANK_M = 64                 # SearchConfig().resolve_m(N) at top_k = 10
N_LSH, N_LSH_PLANTED = 256, 128
EDGE_TOL = 1e-5
CORPUS_SEED = 2014
# mutable path: 16 sealed segments of 262,144 rows after the ingest
TAIL_ROWS, N_DELETE, N_UPSERT, N_REPLANT = 262_144, 419_430, 65_536, 64

# kernel -> (the path whose launch count it reports, its source, the TPU
# kernel it replaces)
KERNELS = {
    "encode_fused": ("main", "src/repro_torch/kernels/csrc/coded_gemm.cu",
                     "src/repro/kernels/encode_fused.py:80"),
    "coded_project": ("main", "src/repro_torch/kernels/csrc/coded_gemm.cu",
                      "src/repro/kernels/proj_code.py:76"),
    "pack_codes": ("main", "src/repro_torch/kernels/csrc/pack_codes.cu",
                   "src/repro/kernels/pack_codes.py:32"),
    "packed_topk": ("main", "src/repro_torch/kernels/csrc/packed_topk.cu",
                    "src/repro/kernels/packed_collision.py:170"),
    "fused_scored_topk": ("scored",
                          "src/repro_torch/kernels/csrc/fused_scored.cu",
                          "src/repro/kernels/fused_scored.py:265"),
    "packed_collision_counts": ("scored",
                                "src/repro_torch/kernels/csrc/packed_counts.cu",
                                "src/repro/kernels/packed_collision.py:90"),
    "packed_lut_rerank": ("scored",
                          "src/repro_torch/kernels/csrc/packed_lut.cu",
                          "src/repro/kernels/packed_lut.py:296"),
    "packed_topk_masked": ("mutable",
                           "src/repro_torch/kernels/csrc/packed_topk.cu",
                           "src/repro/kernels/packed_collision.py:247"),
    "fused_scored_topk_masked": ("mutable",
                                 "src/repro_torch/kernels/csrc/fused_scored.cu",
                                 "src/repro/kernels/fused_scored.py:289"),
    "code_pack": ("url", "src/repro_torch/kernels/csrc/code_pack.cu",
                  "src/repro/kernels/encode_fused.py:128"),
    # no Pallas counterpart: the JAX code they stand in for
    "normal_unit": ("url", "src/repro_torch/kernels/csrc/normal_unit.cu",
                    "src/repro/core/sketch.py:104"),
    "csr_unit_step": ("url", "src/repro_torch/kernels/csrc/csr_step.cu",
                      "src/repro/encode/encoder.py:100"),
}
# path -> every kernel it must launch
PATH_KERNELS = {
    "main": ("encode_fused", "coded_project", "pack_codes", "packed_topk"),
    "scored": ("coded_project", "pack_codes", "packed_topk",
               "packed_collision_counts", "packed_lut_rerank",
               "fused_scored_topk"),
    "mutable": ("encode_fused", "coded_project", "pack_codes",
                "packed_topk_masked", "fused_scored_topk_masked",
                "packed_collision_counts", "packed_lut_rerank"),
    "url": ("code_pack", "normal_unit", "csr_unit_step", "pack_codes",
            "packed_topk", "fused_scored_topk"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events).

    Each run is queued behind a 2 ms spin kernel, so that the host has
    enqueued the call's launches before the card reaches the first event:
    the events then bracket device work, not the host's launch latency,
    which is longer than a small kernel (tens of microseconds)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(ops_s: list, n_bytes: float):
    """Least time (ms) for the work: bytes over the memory rate against
    each (pipe, operations, peak rate) triple. Returns the time, "bytes"
    or "operations", and the pipe (or pipes, joined by "=" when they
    tie) that binds."""
    terms = [("bytes", n_bytes / HBM_BYTES_S)] + \
        [(pipe, n / rate) for pipe, n, rate in ops_s]
    t = max(s for _, s in terms)
    pipes = "=".join(p for p, s in terms if s >= t * (1 - 1e-9))
    return 1e3 * t, ("bytes" if pipes == "bytes" else "operations"), pipes


def require_launched(counts: dict, path: str) -> None:
    """Fails unless every kernel the path runs launched on it."""
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


def edge_distance(z, spec, q):
    """Distance of each projection from its nearest bin edge."""
    import torch
    if spec.scheme == "sign":
        return z.abs()
    if spec.scheme == "2bit":
        w = spec.w
        return torch.stack([(z + w).abs(), z.abs(), (z - w).abs()]).amin(0)
    v = (z + q if spec.scheme == "offset" else z) / spec.w
    return (v - v.round()).abs() * spec.w


def check_codes(got, want, z_ref, spec, q, what: str) -> int:
    """Kernel codes vs plain codes: differences only at bin edges."""
    diff = got != want
    far = diff & (edge_distance(z_ref, spec, q) > EDGE_TOL)
    if bool(far.any()):
        raise AssertionError(f"{what}: {int(far.sum())} fields differ away "
                             f"from a bin edge")
    return int(diff.sum())


def unit_rows(n: int, d: int, gen, device):
    import torch
    x = torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def corpus_chunk(gen, device):
    """The next corpus chunk from ``gen``: unit rows [CHUNK, D] and the
    positions of its planted sources; seeded with ``CORPUS_SEED``, the
    64 calls give the main path's corpus."""
    import torch
    x = unit_rows(CHUNK, D, gen, device)
    pick = torch.randint(0, CHUNK, (N_PLANTED // (N_ROWS // CHUNK),),
                         generator=gen, device=device)
    return x, pick


def small_checks(device) -> None:
    """Ragged shapes, every scheme and bit width: kernel == plain."""
    import torch
    from repro_torch.core import packing, prng
    from repro_torch.core.schemes import CodeSpec, sample_offsets
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(7)
    for scheme, w in (("sign", 1.0), ("2bit", 0.75), ("uniform", 0.75),
                      ("offset", 1.0)):
        spec = CodeSpec(scheme, w)
        for m, d, k in ((1000, 96, 100), (129, 1024, 256), (7, 33, 17)):
            x = unit_rows(m, d, gen, device)
            r = torch.randn((d, k), generator=gen, device=device)
            q = (sample_offsets(prng.PRNGKey(m), k, w).to(device)
                 if scheme == "offset" else None)
            z = torch.matmul(x, r)
            want = ref.coded_project_ref(x, r, spec, q)
            got = ops.coded_project(x, r, spec, q, impl="kernel")
            n1 = check_codes(got, want, z, spec, q,
                             f"coded_project {scheme} {(m, d, k)}")
            words = ops.encode_fused(x, r, spec, q, impl="kernel")
            if words.shape != (m, packing.packed_width(k, spec.bits)):
                raise AssertionError(f"encode_fused shape {tuple(words.shape)}")
            n2 = check_codes(packing.unpack_codes(words, spec.bits, k), want,
                             z, spec, q, f"encode_fused {scheme} {(m, d, k)}")
            # fields past k are zero: words repack from their own codes
            if not torch.equal(words, packing.pack_codes(
                    packing.unpack_codes(words, spec.bits, k), spec.bits)):
                raise AssertionError("encode_fused: nonzero padding fields")
            log(f"check gemm {scheme:7s} m,d,k={m},{d},{k}: edge flips "
                f"coded_project={n1} encode_fused={n2}")
    for bits in (1, 2, 4, 8, 16):
        for m, k in ((1000, 100), (3, 7), (256, 256)):
            codes = torch.randint(0, 1 << bits, (m, k), generator=gen,
                                  device=device, dtype=torch.int32)
            if not torch.equal(ops.pack_codes(codes, bits, impl="kernel"),
                               ref.pack_codes_ref(codes, bits)):
                raise AssertionError(f"pack_codes bits={bits} {(m, k)}")
        for nq, n, k, top_k in ((33, 2000, 100, 10), (5, 37, 64, 50),
                                (8, 100_000, 256, 1024), (9, 70_000, 64, 1)):
            wq = packing.pack_codes(torch.randint(
                0, 1 << bits, (nq, k), generator=gen, device=device), bits)
            wdb = packing.pack_codes(torch.randint(
                0, 1 << bits, (n, k), generator=gen, device=device), bits)
            wdb[n // 2] = wq[0]            # an exact hit
            wdb[n // 3] = wq[0]            # and a tie with a lower id
            got = ops.packed_topk(wq, wdb, bits, k, top_k, impl="kernel")
            want = ref.packed_topk_ref(wq, wdb, bits, k, top_k)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"packed_topk bits={bits} "
                                     f"{(nq, n, k, top_k)}")
        log(f"check pack_codes + packed_topk bits={bits}: bit-exact")
    torch.cuda.synchronize()


def rand_tables(gen, nq: int, w: int, bits: int, dtype: str, device):
    """Random query tables [nq, F*P] of ``dtype`` (f32, bf16, or int8 with
    power-of-two float32 scales [nq, w])."""
    import torch
    fp = (w * (32 // bits)) << bits
    if dtype == "int8":
        t = torch.randint(-127, 128, (nq, fp), generator=gen, device=device,
                          dtype=torch.int8)
        e = torch.randint(-8, 2, (nq, w), generator=gen, device=device)
        return t, torch.pow(2.0, e.to(torch.float32))
    t = torch.randn((nq, fp), generator=gen, device=device)
    return (t.to(torch.bfloat16) if dtype == "bf16" else t), None


def same(got, want) -> bool:
    """Kernel and plain outputs (tuples): same shapes, bit-identical."""
    import torch
    return all(g.shape == w.shape and bool(torch.equal(g, w))
               for g, w in zip(got, want))


def scored_checks(device) -> None:
    """Ragged shapes for the scored-search and LSH kernels: kernel ==
    plain, bit-exact (packed_collision_counts, packed_lut_rerank,
    fused_scored_topk)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(12)

    def words(n, k, bits):
        return packing.pack_codes(torch.randint(
            0, 1 << bits, (n, k), generator=gen, device=device), bits)

    for bits in (1, 2, 4, 8):
        for nq, n, k in ((33, 2000, 100), (5, 37, 64), (9, 70_000, 64),
                         (40, 129, 256), (3, 0, 17)):
            wq, wdb = words(nq, k, bits), words(n, k, bits)
            got = ops.packed_collision_counts(wq, wdb, bits, k, impl="kernel")
            if not same((got,), (ref.packed_collision_ref(wq, wdb, bits, k),)):
                raise AssertionError(f"packed_collision_counts bits={bits} "
                                     f"{(nq, n, k)}")
    log("check packed_collision_counts bits 1/2/4/8: bit-exact")
    for bits in (1, 2, 4):
        for dtype in ("f32", "bf16"):
            # (queries, candidates, k, top_k): random invalid slots, M in the
            # thousands, top_k above the valid count, one candidate
            for nq, m, k, top_k in ((13, 50, 33, 7), (7, 3000, 100, 10),
                                    (4, 5, 17, 9), (2, 1, 64, 3)):
                tab, _ = rand_tables(gen, nq, packing.packed_width(k, bits),
                                     bits, dtype, device)
                cand = words(nq * m, k, bits).reshape(nq, m, -1)
                valid = torch.rand((nq, m), generator=gen, device=device) > 0.3
                got = ops.packed_lut_rerank(tab, cand, valid, bits, top_k,
                                            impl="kernel")
                want = ref.packed_lut_rerank_ref(tab, cand, valid, bits, top_k)
                if not same(got, want):
                    raise AssertionError(f"packed_lut_rerank bits={bits} "
                                         f"{dtype} {(nq, m, k, top_k)}")
            # all candidates tied: equal rows, so positions ascending
            tab, _ = rand_tables(gen, 3, packing.packed_width(33, bits), bits,
                                 dtype, device)
            cand = words(3, 33, bits)[:, None, :].expand(3, 40, -1).contiguous()
            valid = torch.ones((3, 40), dtype=torch.bool, device=device)
            got = ops.packed_lut_rerank(tab, cand, valid, bits, 12,
                                        impl="kernel")
            if not same(got, ref.packed_lut_rerank_ref(tab, cand, valid, bits,
                                                       12)):
                raise AssertionError(f"packed_lut_rerank tied bits={bits}")
        log(f"check packed_lut_rerank bits={bits} f32/bf16: bit-exact")
        for dtype in ("f32", "bf16", "int8"):
            # (queries, rows, k, rerank_m, top_k): rerank_m > N, top_k above
            # the survivors, N not a multiple of any tile, N = 0
            for nq, n, k, m, top_k in ((3, 37, 17, 9, 7), (5, 130, 33, 32, 7),
                                       (9, 5000, 64, 64, 10),
                                       (4, 20, 33, 30, 10),
                                       (6, 3000, 100, 3, 10),
                                       (17, 70_000, 256, 256, 50),
                                       (3, 0, 17, 5, 4)):
                wq, wdb = words(nq, k, bits), words(n, k, bits)
                if n:
                    wdb[n // 2] = wq[0]
                    wdb[n // 3] = wq[0]
                tab, scl = rand_tables(gen, nq, wq.shape[1], bits, dtype,
                                       device)
                got = ops.fused_scored_topk(wq, tab, wdb, bits, k, m, top_k,
                                            scales=scl, impl="kernel")
                want = ref.fused_scored_topk_ref(wq, tab, wdb, bits, k, m,
                                                 top_k, scales=scl)
                if not same(got, want):
                    raise AssertionError(f"fused_scored_topk bits={bits} "
                                         f"{dtype} {(nq, n, k, m, top_k)}")
            # every row tied on count and score: ids ascending
            wq = words(4, 50, bits)
            wdb = wq[1:2].expand(600, -1).contiguous()
            tab, scl = rand_tables(gen, 4, wq.shape[1], bits, dtype, device)
            got = ops.fused_scored_topk(wq, tab, wdb, bits, 50, 40, 12,
                                        scales=scl, impl="kernel")
            if not same(got, ref.fused_scored_topk_ref(wq, tab, wdb, bits, 50,
                                                       40, 12, scales=scl)):
                raise AssertionError(f"fused_scored_topk tied bits={bits}")
        log(f"check fused_scored_topk bits={bits} f32/bf16/int8: bit-exact")
    # 8- and 16-bit tables too large for shared memory: read from device
    # memory
    for bits, k in ((8, 400), (16, 40)):
        for dtype in ("f32", "bf16", "int8"):
            wq, wdb = words(3, k, bits), words(900, k, bits)
            wdb[5] = wq[0]
            tab, scl = rand_tables(gen, 3, wq.shape[1], bits, dtype, device)
            got = ops.fused_scored_topk(wq, tab, wdb, bits, k, 20, 7,
                                        scales=scl, impl="kernel")
            if not same(got, ref.fused_scored_topk_ref(wq, tab, wdb, bits, k,
                                                       20, 7, scales=scl)):
                raise AssertionError(f"fused_scored_topk bits={bits} {dtype}")
            if dtype == "int8":
                continue
            cand = wdb[:150].reshape(3, 50, -1)
            valid = torch.rand((3, 50), generator=gen, device=device) > 0.3
            got = ops.packed_lut_rerank(tab, cand, valid, bits, 7,
                                        impl="kernel")
            if not same(got, ref.packed_lut_rerank_ref(tab, cand, valid, bits,
                                                       7)):
                raise AssertionError(f"packed_lut_rerank bits={bits} {dtype}")
    log("check fused_scored_topk + packed_lut_rerank bits 8/16 (tables in "
        "device memory): bit-exact")
    torch.cuda.synchronize()


def masked_checks(device) -> None:
    """Ragged shapes for the mutable index's masked kernels: kernel ==
    plain, bit-exact (packed_topk_masked, fused_scored_topk_masked)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(13)

    def words(n, k, bits):
        return packing.pack_codes(torch.randint(
            0, 1 << bits, (n, k), generator=gen, device=device), bits)

    def mask(n, dead):
        return packing.pack_bitmask(
            torch.rand((n,), generator=gen, device=device) >= dead)

    # N: empty, one row, inside one mask word, across two, several ranges;
    # dead share: all, none, 10 %, 90 %
    sizes, deads = (0, 1, 31, 33, 3000), (1.0, 0.0, 0.1, 0.9)
    for bits in (1, 2, 4, 8, 16):
        for n in sizes:
            wq, wdb = words(5, 100, bits), words(n, 100, bits)
            if n:
                wdb[n // 2] = wq[0]
                wdb[n // 3] = wq[0]            # a tie with a lower id
            for dead in deads:
                valid = mask(n, dead)
                # top_k above the live count where the limit allows
                for top_k in (1, 10, min(n + 5, 2048)):
                    got = ops.packed_topk_masked(wq, wdb, valid, bits, 100,
                                                 top_k, impl="kernel")
                    if not same(got, ref.packed_topk_masked_ref(
                            wq, wdb, valid, bits, 100, top_k)):
                        raise AssertionError(
                            f"packed_topk_masked bits={bits} n={n} "
                            f"dead={dead} top_k={top_k}")
        # every row tied, half dead: live ids ascending
        wq = words(3, 100, bits)
        wdb = wq[1:2].expand(700, -1).contiguous()
        valid = mask(700, 0.5)
        if not same(ops.packed_topk_masked(wq, wdb, valid, bits, 100, 400,
                                           impl="kernel"),
                    ref.packed_topk_masked_ref(wq, wdb, valid, bits, 100,
                                               400)):
            raise AssertionError(f"packed_topk_masked tied bits={bits}")
    log("check packed_topk_masked bits 1/2/4/8/16, N 0/1/31/33/3000, dead "
        "all/none/10 %/90 %, top_k above the live rows, all tied: bit-exact")
    for bits in (1, 2, 4, 8, 16):
        k = 40 if bits == 16 else 100       # 16-bit tables are 10 MB a query
        for dtype in ("f32", "bf16", "int8"):
            for n in sizes:
                wq, wdb = words(4, k, bits), words(n, k, bits)
                if n:
                    wdb[n // 2] = wq[0]
                    wdb[n // 3] = wq[0]
                tab, scl = rand_tables(gen, 4, wq.shape[1], bits, dtype,
                                       device)
                for dead in deads:
                    valid = mask(n, dead)
                    # rerank_m below and above the live count
                    for m, top_k in ((16, 10), (min(n + 3, 2048), 12)):
                        got = ops.fused_scored_topk_masked(
                            wq, tab, wdb, valid, bits, k, m, top_k,
                            scales=scl, impl="kernel")
                        if not same(got, ref.fused_scored_topk_masked_ref(
                                wq, tab, wdb, valid, bits, k, m, top_k,
                                scales=scl)):
                            raise AssertionError(
                                f"fused_scored_topk_masked bits={bits} "
                                f"{dtype} n={n} dead={dead} m={m}")
            wq = words(3, k, bits)
            wdb = wq[1:2].expand(700, -1).contiguous()
            valid = mask(700, 0.5)
            tab, scl = rand_tables(gen, 3, wq.shape[1], bits, dtype, device)
            if not same(ops.fused_scored_topk_masked(
                    wq, tab, wdb, valid, bits, k, 300, 40, scales=scl,
                    impl="kernel"),
                    ref.fused_scored_topk_masked_ref(
                        wq, tab, wdb, valid, bits, k, 300, 40, scales=scl)):
                raise AssertionError(f"fused_scored_topk_masked tied "
                                     f"bits={bits} {dtype}")
    log("check fused_scored_topk_masked bits 1/2/4/8/16, f32/bf16/int8, N "
        "0/1/31/33/3000, dead all/none/10 %/90 %, rerank_m below and above "
        "the live rows, all tied: bit-exact")
    torch.cuda.synchronize()


def encode_checks(device) -> None:
    """Ragged shapes for the encode kernels: code_pack against its plain
    version over every scheme; the R draw against the CPU's plain
    ``prng`` on all 2^23 mantissas, on whole units and on units 0, 1 and
    789 of the URL sketch; the CSR step against its plain version on
    empty rows, no entries, repeated columns, a row wholly in the ragged
    last unit and rows across many units. All bit-exact."""
    import torch
    from repro_torch.core import packing, prng
    from repro_torch.core.schemes import CodeSpec
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(14)
    for scheme, w in (("sign", 1.0), ("2bit", 0.75), ("uniform", 0.75),
                      ("offset", 1.0)):
        spec = CodeSpec(scheme, w)
        for k in (1, 7, 31, 256):
            q = (torch.rand((k,), generator=gen, device=device) * w
                 if scheme == "offset" else None)
            for m in (0, 1, 33, 3000):
                z = 3.0 * torch.randn((m, k), generator=gen, device=device)
                z[:, ::3] = torch.round(z[:, ::3] / w) * w   # on bin edges
                got = ops.code_pack(z, spec, q, impl="kernel")
                if got.shape != (m, packing.packed_width(k, spec.bits)) or \
                        not torch.equal(got, ref.code_pack_ref(z, spec, q)):
                    raise AssertionError(f"code_pack {scheme} m={m} k={k}")
    log("check code_pack sign/2bit/uniform/offset, M 0/1/33/3000, K "
        "1/7/31/256, a third of the values on bin edges: bit-exact")

    t0 = time.perf_counter()
    bits = torch.arange(1 << 23, dtype=torch.int64) << 9
    want = prng.normal_from_bits(bits)                 # on the CPU
    got = ops.normal_from_bits(packing.as_i32(bits).to(device),
                               impl="kernel")
    if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
        n_bad = int((got.cpu().view(torch.int32)
                     != want.view(torch.int32)).sum())
        raise AssertionError(f"normal draw: {n_bad} of 2^23 mantissas differ "
                             f"from the CPU's plain version")
    log(f"check normal draw on all 2^23 mantissas: bit-identical to the "
        f"CPU's prng ({time.perf_counter() - t0:.1f} s)")
    key = prng.fold_in(prng.PRNGKey(2 ** 31 + 5), 77)
    for width in (1, 217, 4096):
        for k in (1, 7, 256):
            got = ops.normal_unit(key, width, k, device, impl="kernel")
            if not torch.equal(got.cpu().view(torch.int32),
                               prng.normal(key, (width, k)).view(torch.int32)):
                raise AssertionError(f"normal_unit width={width} k={k}")
    url = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), URL_D)
    for u in (0, 1, url.n_units - 1):
        width = url.unit_width(u)
        got = url._block_r(u, width, impl="kernel")
        want = prng.normal(prng.fold_in(url._key, u), (width, K))
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)):
            raise AssertionError(f"URL unit {u} ({width} rows) differs")
    log(f"check normal_unit: widths 1/217/4096 x k 1/7/256 and URL units 0, "
        f"1 and {url.n_units - 1} ({url.unit_width(url.n_units - 1)} rows): "
        f"bit-identical to the CPU's prng")

    d, ru = 10_000, 1024                  # 10 units, the last 784 columns
    for k in (7, 256, 300):
        for n, rows_nnz in ((200, 60), (5, 0), (3, 3000)):
            lens = torch.randint(0, rows_nnz + 1, (n,), generator=gen,
                                 device=device)
            lens[::7] = 0
            indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                            device=device),
                                torch.cumsum(lens, 0)])
            nnz = int(indptr[-1])
            cols = torch.randint(0, d, (nnz,), generator=gen, device=device,
                                 dtype=torch.int32)
            if n > 5 and int(lens[5]):      # row 5 wholly in the last unit
                a = int(indptr[5])
                cols[a:a + int(lens[5])] = d - 1 - torch.arange(
                    int(lens[5]), device=device, dtype=torch.int32) % 9
            if n > 3 and int(lens[3]) > 4:  # repeated columns in row 3
                a = int(indptr[3])
                cols[a + 1:a + 4] = cols[a]
            data = torch.randn((nnz,), generator=gen, device=device)
            acc_k = torch.randn((n, k), generator=gen, device=device)
            acc_r = acc_k.clone()
            for u in range((d + ru - 1) // ru):
                r = torch.randn((min(ru, d - u * ru), k), generator=gen,
                                device=device)
                ops.csr_unit_step(acc_k, indptr, cols, data, r, u * ru,
                                  impl="kernel")
                ops.csr_unit_step(acc_r, indptr, cols, data, r, u * ru,
                                  impl="ref")
            if not torch.equal(acc_k.view(torch.int32),
                               acc_r.view(torch.int32)):
                raise AssertionError(f"csr_unit_step k={k} n={n} nnz={nnz}")
    log("check csr_unit_step k 7/256/300 over 10 units (ragged last), empty "
        "rows, no entries, repeated columns, a row in the last unit only, "
        "3,000-entry rows: bit-exact")
    torch.cuda.synchronize()


def kernel_phase(crp, device) -> dict:
    """Main-path shapes: each kernel vs its plain version, times, bounds."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    spec, r, q = crp.spec, crp.stream_encoder().r_matrix(), crp._offsets
    bits, w_words = spec.bits, packing.packed_width(K, spec.bits)
    gen = torch.Generator(device=device).manual_seed(11)
    rows = {}

    def gemm(name, m, fn_kernel, fn_plain, out_bytes):
        x = unit_rows(m, D, gen, device)
        z = torch.matmul(x, r)
        want = ref.coded_project_ref(x, r, spec, q)
        got = fn_kernel(x)
        if name == "encode_fused":
            got = packing.unpack_codes(got, bits, K)
        flips = check_codes(got, want, z, spec, q, name)
        err = int((got - want).abs().max())
        ms = time_ms(lambda: fn_kernel(x))
        plain_ms = time_ms(lambda: fn_plain(x))
        lib_ms = time_ms(lambda: torch.matmul(x, r))
        b_ms, b_by, pipe = bound([("f32", 2.0 * m * D * K, F32_FLOP_S)],
                                 4.0 * (m * D + D * K) + out_bytes(m))
        log(f"kernel {name}: [{m},{D}]x[{D},{K}] edge flips {flips}/{m * K} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} gemm_library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}, {pipe})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, bound_pipe=pipe, library_ms=None,
                    gemm_library_ms=lib_ms, shape=[m, D, K], edge_flips=flips)

    rows["encode_fused"] = gemm(
        "encode_fused", CHUNK,
        lambda x: ops.encode_fused(x, r, spec, q, impl="kernel"),
        lambda x: ops.encode_fused(x, r, spec, q, impl="ref"),
        lambda m: 4.0 * m * w_words)
    rows["coded_project"] = gemm(
        "coded_project", N_QUERIES,
        lambda x: ops.coded_project(x, r, spec, q, impl="kernel"),
        lambda x: ops.coded_project(x, r, spec, q, impl="ref"),
        lambda m: 4.0 * m * K)

    codes = torch.randint(0, 1 << bits, (CHUNK_Q, K), generator=gen,
                          device=device, dtype=torch.int32)
    got = ops.pack_codes(codes, bits, impl="kernel")
    want = ref.pack_codes_ref(codes, bits)
    if not torch.equal(got, want):
        raise AssertionError("pack_codes differs from its plain version")
    b_ms, b_by, pipe = bound([("int32", 2.0 * CHUNK_Q * K, INT32_OP_S)],
                             4.0 * CHUNK_Q * (K + w_words))
    rows["pack_codes"] = dict(
        max_abs_err=0, ms=time_ms(lambda: ops.pack_codes(codes, bits, impl="kernel")),
        plain_ms=time_ms(lambda: ref.pack_codes_ref(codes, bits)),
        bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe, library_ms=None,
        shape=[CHUNK_Q, K])
    log(f"kernel pack_codes: [{CHUNK_Q},{K}] bit-exact "
        f"ms={rows['pack_codes']['ms']:.4f} "
        f"plain_ms={rows['pack_codes']['plain_ms']:.4f} "
        f"bound_ms={b_ms:.6f} ({b_by}, {pipe})")

    codes_q = torch.randint(0, 1 << bits, (CHUNK_Q, K), generator=gen,
                            device=device)
    wq = packing.pack_codes(codes_q, bits)
    wdb = torch.randint(-2 ** 31, 2 ** 31, (N_ROWS, w_words), generator=gen,
                        device=device, dtype=torch.int64).to(torch.int32)
    got = ops.packed_topk(wq, wdb, bits, K, TOP_K, impl="kernel")
    want = ref.packed_topk_ref(wq, wdb, bits, K, TOP_K)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("packed_topk differs from its plain version")
    # per (query, row, word): one popcount, and besides it an xor,
    # log2(b) shifts and ors (the last or merges with the field mask into
    # one LOP3) and the add into the count
    int_word = 2 + 2 * int(math.log2(bits))
    pairs = float(CHUNK_Q) * N_ROWS * w_words
    b_ms, b_by, pipe = bound([("popc", pairs, POPC_OP_S),
                              ("int32", pairs * int_word, INT32_OP_S)],
                             4.0 * (N_ROWS * w_words + CHUNK_Q * w_words
                                    + 2 * CHUNK_Q * TOP_K))
    rows["packed_topk"] = dict(
        max_abs_err=0,
        ms=time_ms(lambda: ops.packed_topk(wq, wdb, bits, K, TOP_K, impl="kernel")),
        plain_ms=time_ms(lambda: ref.packed_topk_ref(wq, wdb, bits, K, TOP_K),
                         reps=10, warmup=1),
        bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe, library_ms=None,
        shape=[CHUNK_Q, N_ROWS, w_words, TOP_K])
    log(f"kernel packed_topk: Q={CHUNK_Q} N={N_ROWS} W={w_words} "
        f"top_k={TOP_K} bit-exact ms={rows['packed_topk']['ms']:.4f} "
        f"plain_ms={rows['packed_topk']['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}, {pipe})")
    scored_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word)
    masked_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word)
    del wdb
    torch.cuda.empty_cache()
    return rows


def scored_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word) -> None:
    """The scored-search and LSH kernels at the main path's shapes, on the
    packed_topk phase's queries and corpus, with the sketcher's tables."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    from repro_torch.rank import build_rank_tables
    bits, nq = crp.spec.bits, CHUNK_Q
    w_words = packing.packed_width(K, bits)
    q_tab = build_rank_tables(crp).query_tables(codes_q)
    fp = q_tab.shape[1]
    pairs = float(nq) * N_ROWS * w_words
    count_ops = [("popc", pairs, POPC_OP_S),
                 ("int32", pairs * int_word, INT32_OP_S)]

    def row(name, fn_kernel, fn_plain, want, b, shape, plain_reps=10):
        t0 = time.perf_counter()
        got = fn_kernel()
        if not same(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
            raise AssertionError(f"{name} differs from its plain version")
        del got, want
        ms = time_ms(fn_kernel)
        plain_ms = time_ms(fn_plain, reps=plain_reps, warmup=1)
        b_ms, b_by, pipe = b
        rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe,
                          library_ms=None, shape=shape)
        log(f"kernel {name}: {shape} bit-exact ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, {pipe}); "
            f"phase {time.perf_counter() - t0:.1f} s")

    row("packed_collision_counts",
        lambda: ops.packed_collision_counts(wq, wdb, bits, K, impl="kernel"),
        lambda: ref.packed_collision_ref(wq, wdb, bits, K),
        ref.packed_collision_ref(wq, wdb, bits, K),
        bound(count_ops, 4.0 * (N_ROWS * w_words + nq * w_words
                                + nq * N_ROWS)),
        [nq, N_ROWS, w_words], plain_reps=3)
    torch.cuda.empty_cache()
    # the least work is one count sweep: the popcounts of B4, no more
    row("fused_scored_topk",
        lambda: ops.fused_scored_topk(wq, q_tab, wdb, bits, K, RERANK_M,
                                      TOP_K, impl="kernel"),
        lambda: ref.fused_scored_topk_ref(wq, q_tab, wdb, bits, K, RERANK_M,
                                          TOP_K),
        ref.fused_scored_topk_ref(wq, q_tab, wdb, bits, K, RERANK_M, TOP_K),
        bound(count_ops, 4.0 * (N_ROWS * w_words + nq * (w_words + fp)
                                + 2 * nq * TOP_K)),
        [nq, N_ROWS, w_words, RERANK_M, TOP_K], plain_reps=3)
    torch.cuda.empty_cache()
    cand_ids = torch.randint(0, N_ROWS, (nq, RERANK_M), generator=gen,
                             device=wdb.device)
    cand = wdb[cand_ids]
    valid = torch.rand((nq, RERANK_M), generator=gen, device=wdb.device) > 0.1
    lookups = float(nq) * RERANK_M * w_words * (32 // bits)
    row("packed_lut_rerank",
        lambda: ops.packed_lut_rerank(q_tab, cand, valid, bits, TOP_K,
                                      impl="kernel"),
        lambda: ref.packed_lut_rerank_ref(q_tab, cand, valid, bits, TOP_K),
        ref.packed_lut_rerank_ref(q_tab, cand, valid, bits, TOP_K),
        bound([("f32", lookups, F32_FLOP_S)],
              4.0 * nq * (fp + RERANK_M * w_words + 2 * TOP_K)
              + nq * RERANK_M),
        [nq, RERANK_M, w_words, TOP_K])


def masked_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word) -> None:
    """The masked kernels at the mutable path's shapes: one 262,144-row
    segment, and the whole 4,194,304-row corpus with 10 % of its rows
    dead (the row of the kernels line), on the packed_topk phase's
    queries and corpus."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    from repro_torch.rank import build_rank_tables
    bits, nq = crp.spec.bits, CHUNK_Q
    w_words = packing.packed_width(K, bits)
    q_tab = build_rank_tables(crp).query_tables(codes_q)
    fp = q_tab.shape[1]
    segment_ms = {}
    for n in (TAIL_ROWS, N_ROWS):
        db = wdb[:n]
        live = torch.rand((n,), generator=gen, device=db.device) >= 0.1
        valid = packing.pack_bitmask(live)
        n_live = int(live.sum())
        # dead rows skip their popcounts: the least work counts live rows;
        # every row's words and the mask are read once
        pairs = float(nq) * n_live * w_words
        count_ops = [("popc", pairs, POPC_OP_S),
                     ("int32", pairs * int_word, INT32_OP_S)]
        db_bytes = 4.0 * n * w_words + n / 8
        cases = {
            "packed_topk_masked": (
                lambda: ops.packed_topk_masked(wq, db, valid, bits, K, TOP_K,
                                               impl="kernel"),
                lambda: ref.packed_topk_masked_ref(wq, db, valid, bits, K,
                                                   TOP_K),
                db_bytes + 4.0 * (nq * w_words + 2 * nq * TOP_K),
                [nq, n, w_words, TOP_K]),
            "fused_scored_topk_masked": (
                lambda: ops.fused_scored_topk_masked(
                    wq, q_tab, db, valid, bits, K, RERANK_M, TOP_K,
                    impl="kernel"),
                lambda: ref.fused_scored_topk_masked_ref(
                    wq, q_tab, db, valid, bits, K, RERANK_M, TOP_K),
                db_bytes + 4.0 * (nq * (w_words + fp) + 2 * nq * TOP_K),
                [nq, n, w_words, RERANK_M, TOP_K]),
        }
        for name, (fn_kernel, fn_plain, n_bytes, shape) in cases.items():
            t0 = time.perf_counter()
            if not same(fn_kernel(), fn_plain()):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at N={n}")
            ms = time_ms(fn_kernel)
            plain_ms = time_ms(fn_plain, reps=3, warmup=1)
            b_ms, b_by, pipe = bound(count_ops, n_bytes)
            log(f"kernel {name}: {shape} live {n_live} bit-exact "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
                f"({b_by}, {pipe}); phase {time.perf_counter() - t0:.1f} s")
            if n == N_ROWS:
                rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  bound_pipe=pipe, library_ms=None,
                                  shape=shape, live_rows=n_live,
                                  segment_ms=segment_ms[name])
            else:
                segment_ms[name] = ms
        torch.cuda.empty_cache()


def main_path(device) -> tuple:
    """Ingest -> store -> engine -> search -> add -> search, counted."""
    import torch
    from repro_torch.ann import AnnEngine, BandSpec, CodeStore
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.kernels import ops, ref

    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), D)
    gen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    ops.reset_launch_counts()
    # set-up, once per sketcher: R drawn on the CPU and cached on the card
    t0 = time.perf_counter()
    crp.stream_encoder().r_matrix()
    torch.cuda.synchronize()
    log(f"R set-up: {1e3 * (time.perf_counter() - t0):.3f} ms")
    # the timed window holds the sketch calls and the store's assembly
    # only: making each chunk's rows and picking its planted rows stand
    # outside it, behind a synchronisation
    words, sources, src_ids, chunk_s = [], [], [], []
    for c in range(N_ROWS // CHUNK):
        x, pick = corpus_chunk(gen, device)
        sources.append(x[pick])
        src_ids.append(pick + c * CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words.append(crp.sketch(x))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    store = CodeStore.from_words(torch.cat(words), K, crp.spec.bits)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    del words
    t_ingest = sum(chunk_s) + t_store
    t0 = time.perf_counter()
    engine = AnnEngine(crp, store, BandSpec(16, 4))
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    chunk_ms = sorted(1e3 * s for s in chunk_s)
    log(f"ingest: {N_ROWS} rows in {t_ingest:.4f} s = "
        f"{N_ROWS / t_ingest:.0f} rows/s (sketch calls + store assembly "
        f"{1e3 * t_store:.3f} ms); sketch ms a {CHUNK}-row chunk: min "
        f"{chunk_ms[0]:.4f} median {statistics.median(chunk_ms):.4f} max "
        f"{chunk_ms[-1]:.4f}; store {store.nbytes} bytes; band hashes in "
        f"{t_engine:.3f} s")

    noise = 0.1 / math.sqrt(D)
    sources = torch.cat(sources)
    src_ids = torch.cat(src_ids).to(torch.int32)
    planted = sources + noise * torch.randn(sources.shape, generator=gen,
                                            device=device)
    queries = torch.cat([planted,
                         unit_rows(N_QUERIES - N_PLANTED, D, gen, device)])
    engine.search(queries[:CHUNK_Q], top_k=TOP_K, chunk_q=CHUNK_Q)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, rho = engine.search(queries, top_k=TOP_K, chunk_q=CHUNK_Q)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    hits = int((ids[:N_PLANTED, 0] == src_ids).sum())
    log(f"search: {N_QUERIES} queries in {t_search:.4f} s = "
        f"{N_QUERIES / t_search:.1f} queries/s; planted at rank 0: "
        f"{hits}/{N_PLANTED}; planted rho_hat median "
        f"{float(rho[:N_PLANTED, 0].median()):.4f}, random-query top rho_hat "
        f"median {float(rho[N_PLANTED:, 0].median()):.4f}")
    if hits != N_PLANTED:
        raise AssertionError(f"planted queries at rank 0: {hits}/{N_PLANTED}")
    if ids.shape != (N_QUERIES, TOP_K) or not bool(torch.isfinite(rho).all()):
        raise AssertionError("search output has the wrong shape or non-finite rho")

    batch = unit_rows(CHUNK, D, gen, device)
    t0 = time.perf_counter()
    engine = engine.add(batch)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    n_new = 64
    new_planted = batch[:n_new] + noise * torch.randn((n_new, D),
                                                      generator=gen,
                                                      device=device)
    queries2 = torch.cat([queries[:N_QUERIES - n_new], new_planted])
    ids2, rho2 = engine.search(queries2, top_k=TOP_K, chunk_q=CHUNK_Q)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    new_ids = torch.arange(N_ROWS, N_ROWS + n_new, device=device,
                           dtype=torch.int32)
    hits2 = int((ids2[:N_PLANTED, 0] == src_ids).sum()) + \
        int((ids2[N_QUERIES - n_new:, 0] == new_ids).sum())
    log(f"add: {CHUNK} rows in {t_add:.3f} s, n={engine.n}; planted at rank "
        f"0 after add: {hits2}/{N_PLANTED + n_new}")
    log(f"launch counts on the main path: {json.dumps(counts)}")
    if hits2 != N_PLANTED + n_new:
        raise AssertionError(f"after add: {hits2}/{N_PLANTED + n_new}")
    if engine.n != N_ROWS + CHUNK:
        raise AssertionError(f"engine.n {engine.n}")
    require_launched(counts, "main")

    pick = torch.cat([torch.arange(8, device=device),
                      torch.arange(N_QUERIES - 8, N_QUERIES, device=device)])
    q_codes = engine.encode_queries(queries2[pick])
    q_words = ref.pack_codes_ref(q_codes, crp.spec.bits)
    want_v, want_i = ref.packed_topk_ref(q_words, engine.store.words,
                                         crp.spec.bits, K, TOP_K)
    if not torch.equal(ids2[pick], want_i) or \
            not torch.equal(rho2[pick], engine._rho(want_v)):
        raise AssertionError("16-query recheck against packed_topk_ref failed")
    log("recheck: 16 queries bit-exact against packed_topk_ref over "
        f"{engine.n} rows")
    rates = dict(ingest_rows_s=N_ROWS / t_ingest,
                 search_queries_s=N_QUERIES / t_search)
    return counts, rates, engine, queries2, dict(
        queries=queries, src_ids=src_ids, sources=sources)


# JAX's float32 2-bit, w = 0.75, k = 256 tables
# (repro.rank.build_rank_tables(CodeSpec("2bit", 0.75), 256)): the pair
# table, and score_grid at five indices
JAX_PAIR = [
    [1.2127269506454468, -0.2013745903968811, -2.9478564262390137,
     -7.9080915451049805],
    [-0.2013746201992035, 0.7243614196777344, -0.1354592740535736,
     -2.9478559494018555],
    [-2.9478559494018555, -0.13545948266983032, 0.7243613004684448,
     -0.2013746201992035],
    [-7.908156871795654, -2.9478561878204346, -0.2013745754957199,
     1.2127269506454468]]
JAX_SCORE_POINTS = {0: -353.320068359375, 128: -224.7241668701172,
                    256: -92.25975799560547, 384: 48.576019287109375,
                    511: 239.96676635742188}

def check_rank_tables(tables) -> None:
    """The port's float64-built tables against JAX's float32 ones."""
    import torch
    pair = tables.pair.cpu().double()
    want = torch.tensor(JAX_PAIR, dtype=torch.float64)
    err = float(((pair - want).abs() / want.abs()).max())
    grid = tables.score_grid.cpu().double()
    g_err = max(abs(float(grid[i]) - v) / abs(v)
                for i, v in JAX_SCORE_POINTS.items())
    log(f"rank tables: pair max relative error {err:.3e}, score_grid "
        f"{g_err:.3e} at {len(JAX_SCORE_POINTS)} points (limit 1e-4)")
    if err > 1e-4 or g_err > 1e-4:
        raise AssertionError("rank tables differ from JAX's beyond 1e-4")


def scored_path(engine, queries, src_ids, sources, device) -> tuple:
    """Scored and LSH search over the store after ``add``, counted:
    scored fused (f32 and int8 tables) and two-stage over 1,024 queries,
    LSH count-ranked and scored over one 256-query chunk; then gates, a
    16-query recheck of each mode through the plain versions, and the
    count-vs-scored hit rate on harder queries."""
    import torch
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    tables = engine.rank_tables
    torch.cuda.synchronize()
    log(f"rank tables set-up: {1e3 * (time.perf_counter() - t0):.3f} ms")
    check_rank_tables(tables)
    lsh_q = torch.cat([queries[:N_LSH_PLANTED],
                       queries[N_PLANTED:N_PLANTED + N_LSH - N_LSH_PLANTED]])
    modes = {   # name: (queries, warm-up chunk, search kwargs)
        "scored_f32": (queries, True, dict(scored=True)),
        "scored_int8": (queries, True, dict(scored=True, table_dtype="int8")),
        "two_stage": (queries, True, dict(scored=True, fused=False)),
        "lsh": (lsh_q, False, dict(mode="lsh")),
        "lsh_scored": (lsh_q, False, dict(mode="lsh", scored=True)),
    }
    out, rates = {}, {}
    ops.reset_launch_counts()
    for name, (qs, warm, kw) in modes.items():
        if warm:
            engine.search(qs[:CHUNK_Q], top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = engine.search(qs, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[f"{name}_queries_s"] = qs.shape[0] / dt
        ids, rho = out[name]
        n_pl = N_PLANTED if qs is queries else N_LSH_PLANTED
        hits = int((ids[:n_pl, 0] == src_ids[:n_pl]).sum())
        log(f"search {name}: {qs.shape[0]} queries in {dt:.4f} s = "
            f"{qs.shape[0] / dt:.1f} queries/s; planted at rank 0: "
            f"{hits}/{n_pl}; planted rho_hat median "
            f"{float(rho[:n_pl, 0].median()):.4f}")
        if ids.shape != (qs.shape[0], TOP_K) or \
                not bool(torch.isfinite(rho).all()):
            raise AssertionError(f"{name}: wrong shape or non-finite rho")
        if name != "scored_int8" and hits != n_pl:
            raise AssertionError(f"{name}: planted at rank 0 {hits}/{n_pl}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"launch counts on the scored and LSH path: {json.dumps(counts)}")
    require_launched(counts, "scored")

    # fused == two-stage, but where LUT scores tie across counts
    (fi, fr), (ti, tr) = out["scored_f32"], out["two_stage"]
    diff = torch.nonzero(((fi != ti) | (fr != tr)).any(dim=1)).flatten()
    q_codes = engine.encode_queries(queries[diff])
    q_words = ref.pack_codes_ref(q_codes, engine.store.bits)
    q_tab = tables.query_tables(q_codes)
    m = SearchConfig(top_k=TOP_K).resolve_m(engine.n)
    ties = 0
    for i in range(diff.numel()):
        sl = slice(i, i + 1)
        a = ref.fused_scored_topk_ref(q_words[sl], q_tab[sl],
                                      engine.store.words, engine.store.bits,
                                      K, m, TOP_K)
        b = ref.two_stage_scored_ref(q_words[sl], q_tab[sl],
                                     engine.store.words, engine.store.bits,
                                     K, m, TOP_K)
        if same(a, b):
            raise AssertionError(f"query {int(diff[i])}: fused and two-stage "
                                 f"differ without a cross-count tie")
        ties += 1
    log(f"fused vs two-stage: {N_QUERIES - ties}/{N_QUERIES} queries equal "
        f"in ids and rho_hat; {ties} differ, each at LUT scores tied across "
        f"collision counts (the plain versions differ there too)")

    # each mode against the same engine through the plain versions
    pick = torch.cat([torch.arange(8, device=device),
                      torch.arange(N_LSH - 8, N_LSH, device=device)])
    for name, (qs, _, kw) in modes.items():
        cfg = SearchConfig(top_k=TOP_K, chunk_q=16, impl="ref", **kw)
        want = engine.search_codes(engine.encode_queries(qs[pick]), cfg)
        if not same(tuple(t[pick] for t in out[name]), want):
            raise AssertionError(f"{name}: 16-query recheck failed")
    log(f"recheck: 16 queries of each mode bit-exact against the plain "
        f"versions over {engine.n} rows")

    # quality: planted neighbours at cosine about 0.9 (noise norm 0.48)
    # and about 0.6 (noise norm 1.33), count-ranked against scored
    gen = torch.Generator(device=device).manual_seed(90)
    for noise in (0.48, 1.33):
        hard = sources + (noise / math.sqrt(D)) * torch.randn(
            sources.shape, generator=gen, device=device)
        cos = float(((hard / hard.norm(dim=1, keepdim=True)) * sources)
                    .sum(1).mean())
        hit = {}
        for name, kw in (("count", {}), ("scored", dict(scored=True))):
            ids, _ = engine.search(hard, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
            hit[name] = float((ids[:, 0] == src_ids).float().mean())
            rates[f"rank0_{name}_cos{cos:.2f}"] = hit[name]
        log(f"planted queries at mean cosine {cos:.4f} ({sources.shape[0]} "
            f"queries): rank-0 hit rate count-ranked {hit['count']:.4f}, "
            f"scored {hit['scored']:.4f}")
    rates["fused_two_stage_cross_count_ties"] = ties
    return counts, rates


def per_segment_oracle(mut, queries, kw: dict):
    """Scored search as the mutable engine defines it, without masks:
    each segment's live rows gathered into a dense corpus and searched
    with the unmasked kernels (B5; or B4 or B9 then B10) at that
    segment's rerank_m, rows mapped to external ids, the lists merged in
    log order -> (ids, rho_hat)."""
    import torch
    from repro_torch.ann.bands import probe_hashes
    from repro_torch.ann.engine import (SearchConfig, _coarse_band_scores,
                                        lut_rerank_stage, merge_topk,
                                        resolve_query_tables, rho_scored)
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    cfg = SearchConfig(top_k=TOP_K, **kw)
    tables, bits = mut.rank_tables, mut.store.bits
    q_codes = mut.encode_queries(queries)
    q_words = ops.pack_codes(q_codes, bits)
    q_tab, scales = resolve_query_tables(tables, q_codes, cfg.table_dtype)
    qh = packing.as_i32(probe_hashes(q_codes, mut.band_spec, cfg.n_probes))
    vals_l, ids_l = [], []
    for seg in mut.store.segments():
        if seg.live == 0:
            continue
        live_np = seg.live_rows()
        live = torch.from_numpy(live_np).to(q_codes.device)
        words, m = seg.words[live], cfg.resolve_m(seg.cap)
        if cfg.use_fused():
            vals, rows = ops.fused_scored_topk(q_words, q_tab, words, bits, K,
                                               m, TOP_K, scales=scales)
        else:
            if cfg.mode == "exact":
                _, rows = ops.packed_topk(q_words, words, bits, K, m)
            else:
                counts = ops.packed_collision_counts(q_words, words, bits, K)
                keep = _coarse_band_scores(qh, seg.hashes[live]) >= \
                    cfg.min_bands
                _, rows = ref.topk_stable_ref(
                    torch.where(keep, counts, torch.full_like(counts, -1)), m)
            rows, vals = lut_rerank_stage(tables, q_codes, rows, words, TOP_K,
                                          q_tables=q_tab)
        ext = torch.from_numpy(seg.ids[live_np].astype("int32")).to(
            q_codes.device)[rows.clamp(min=0).long()]
        ids_l.append(torch.where(rows < 0, torch.full_like(ext, -1), ext))
        vals_l.append(vals)
    vals, ids = merge_topk(vals_l, ids_l, TOP_K)
    return ids, rho_scored(tables, ids, vals)


def mutable_path(engine, state, device, profile: bool = False) -> tuple:
    """Ingest -> churn -> search in every mode -> compact -> snapshot ->
    restore -> search, through ``MutableAnnEngine`` over the main path's
    corpus. Launches are counted over the path's own calls only; the
    gates (fresh immutable engines, the per-segment oracle, the plain
    versions) run between them."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.ann import AnnEngine, BandSpec, CodeStore
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.index import CompactionPolicy, MutableAnnEngine
    from repro_torch.kernels import ops
    crp, bits = engine.sketcher, engine.sketcher.spec.bits
    counts = dict.fromkeys(ops.launch_counts(), 0)
    rates = {}

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for key, v in ops.launch_counts().items():
            counts[key] += v
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = counted(fn)
        return out, time.perf_counter() - t0

    # 1. ingest: the main path's rows, made outside the timed window
    mut = MutableAnnEngine(crp, band_spec=BandSpec(16, 4),
                           tail_rows=TAIL_ROWS)
    gen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    chunk_s = []
    for _ in range(N_ROWS // CHUNK):
        x, _ = corpus_chunk(gen, device)
        chunk_s.append(timed(lambda: mut.ingest(x, chunk_rows=CHUNK))[1])
    store = mut.store
    t_ingest = sum(chunk_s)
    rates["ingest_rows_s"] = N_ROWS / t_ingest
    chunk_ms = sorted(1e3 * c for c in chunk_s)
    log(f"mutable ingest: {N_ROWS} rows in {t_ingest:.4f} s = "
        f"{N_ROWS / t_ingest:.0f} rows/s; ms a {CHUNK}-row call: min "
        f"{chunk_ms[0]:.4f} median {statistics.median(chunk_ms):.4f} max "
        f"{chunk_ms[-1]:.4f}; {store.n_segments} segments, "
        f"{store.nbytes} bytes")
    if (mut.n, len(store.sealed), store.tail.length) != \
            (N_ROWS, N_ROWS // TAIL_ROWS, 0):
        raise AssertionError(f"after ingest: {store.stats()}")
    if not torch.equal(store.live_words(), engine.store.words[:N_ROWS]):
        raise AssertionError("ingested words differ from the main path's "
                             "store")

    # 2. churn: ids on the host from a seed, new rows on the card
    rng = np.random.default_rng(CORPUS_SEED)
    src_ids = state["src_ids"]
    src_np = src_ids.cpu().numpy().astype(np.int64)
    src = np.unique(src_np)
    gone_src = rng.choice(src, src.size // 4, replace=False)
    others = rng.permutation(N_ROWS)
    others = others[~np.isin(others, src)]
    n_other = N_DELETE - gone_src.size
    del_ids = np.concatenate([gone_src, others[:n_other]])
    killed, t_del = timed(lambda: mut.delete(del_ids))
    replant = rng.choice(src[~np.isin(src, gone_src)], N_REPLANT,
                         replace=False)
    up_ids = np.concatenate([replant,
                             others[n_other:n_other + N_UPSERT - N_REPLANT]])
    x_up = unit_rows(N_UPSERT, D, gen, device)
    _, t_up = timed(lambda: mut.upsert(up_ids, x_up))
    x_add = unit_rows(CHUNK, D, gen, device)
    add_ids, t_add = timed(lambda: mut.add(x_add))
    for what, n, t in (("delete", killed, t_del), ("upsert", N_UPSERT, t_up),
                       ("add", CHUNK, t_add)):
        rates[f"{what}_ms"] = 1e3 * t
        rates[f"{what}_rows_s"] = n / t
        log(f"mutable {what}: {n} rows in {1e3 * t:.3f} ms = {n / t:.0f} "
            f"rows/s")
    want = (N_ROWS - N_DELETE + CHUNK, N_ROWS // TAIL_ROWS + 1,
            N_UPSERT + CHUNK)
    if killed != N_DELETE or (mut.n, store.n_segments,
                              store.tail.length) != want:
        raise AssertionError(f"after churn: killed {killed}, {store.stats()}")
    log(f"after churn: {store.stats()}")

    # queries: the main path's, the re-planted sources' replaced
    noise = 0.1 / math.sqrt(D)
    queries = state["queries"].clone()
    at = {int(i): j for j, i in enumerate(replant)}
    moved = np.flatnonzero(np.isin(src_np, replant))
    rows_up = torch.tensor([at[int(i)] for i in src_np[moved]], device=device)
    queries[torch.from_numpy(moved).to(device)] = x_up[rows_up] + noise * \
        torch.randn((moved.size, D), generator=gen, device=device)
    alive = torch.from_numpy(np.flatnonzero(~np.isin(src_np, gone_src))).to(
        device)
    moved_t = torch.from_numpy(moved).to(device)
    lsh_q = torch.cat([queries[:N_LSH_PLANTED],
                       queries[N_PLANTED:N_PLANTED + N_LSH - N_LSH_PLANTED]])
    lsh_alive = alive[alive < N_LSH_PLANTED]
    dead = torch.from_numpy(del_ids).to(device)
    modes = {   # name: (queries, warm-up chunk, search kwargs)
        "count": (queries, True, {}),
        "scored_f32": (queries, True, dict(scored=True)),
        "scored_int8": (queries, True, dict(scored=True, table_dtype="int8")),
        "two_stage": (queries, True, dict(scored=True, fused=False)),
        "lsh": (lsh_q, False, dict(mode="lsh")),
        "lsh_scored": (lsh_q, False, dict(mode="lsh", scored=True)),
    }

    def search_all(eng, tag):
        out = {}
        for name, (qs, warm, kw) in modes.items():
            if warm:
                counted(lambda: eng.search(qs[:CHUNK_Q], top_k=TOP_K,
                                           chunk_q=CHUNK_Q, **kw))
            out[name], dt = timed(lambda: eng.search(
                qs, top_k=TOP_K, chunk_q=CHUNK_Q, **kw))
            rates[f"{tag}_{name}_queries_s"] = qs.shape[0] / dt
            ids, rho = out[name]
            if ids.shape != (qs.shape[0], TOP_K) or \
                    not bool(torch.isfinite(rho).all()):
                raise AssertionError(f"{tag} {name}: wrong shape or "
                                     f"non-finite rho")
            if bool(torch.isin(ids, dead).any()):
                raise AssertionError(f"{tag} {name}: a deleted id came back")
            pl = lsh_alive if kw.get("mode") == "lsh" else alive
            hits = int((ids[pl, 0] == src_ids[pl]).sum())
            rp = moved_t if kw.get("mode") != "lsh" else \
                moved_t[moved_t < N_LSH_PLANTED]
            rp_hits = int((ids[rp, 0] == src_ids[rp]).sum())
            log(f"{tag} search {name}: {qs.shape[0]} queries in {dt:.4f} s "
                f"= {qs.shape[0] / dt:.1f} queries/s; live planted at rank "
                f"0: {hits}/{pl.numel()}, re-planted {rp_hits}/{rp.numel()}")
            if name != "scored_int8" and hits != pl.numel():
                raise AssertionError(f"{tag} {name}: planted at rank 0 "
                                     f"{hits}/{pl.numel()}")
        return out

    def check_fresh(eng, out, tag):
        """Count-ranked: equal to one fresh immutable engine over the live
        rows. Scored: equal to the per-segment oracle; agreement with the
        whole-store engine is counted."""
        live_ids = torch.from_numpy(eng.store.live_ids().astype(np.int32)).to(
            device)
        fresh = AnnEngine(crp, CodeStore.from_words(eng.store.live_words(), K,
                                                    bits),
                          BandSpec(16, 4), rank_tables=eng.rank_tables)
        for name, (qs, _, kw) in modes.items():
            rows, rho = fresh.search(qs, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
            ids = torch.where(rows < 0, torch.full_like(rows, -1),
                              live_ids[rows.clamp(min=0).long()])
            agree = int(((ids == out[name][0]).all(1)
                         & (rho == out[name][1]).all(1)).sum())
            if not kw.get("scored"):
                if agree != qs.shape[0]:
                    raise AssertionError(f"{tag} {name}: {agree}/"
                                         f"{qs.shape[0]} queries equal the "
                                         f"fresh immutable engine")
                log(f"{tag} {name}: {agree}/{qs.shape[0]} queries bit-exact "
                    f"against a fresh immutable engine over "
                    f"{eng.n} live rows")
                continue
            if not same(out[name], per_segment_oracle(eng, qs, kw)):
                raise AssertionError(f"{tag} {name}: differs from the "
                                     f"per-segment oracle")
            log(f"{tag} {name}: bit-exact against the per-segment oracle; "
                f"{agree}/{qs.shape[0]} queries equal the whole-store "
                f"engine (the coarse top-{RERANK_M} is taken per segment)")
        del fresh

    # 3. search, 4. gates
    out = search_all(mut, "churned")
    check_fresh(mut, out, "churned")
    pick = torch.cat([torch.arange(8, device=device),
                      torch.arange(N_LSH - 8, N_LSH, device=device)])
    for name, (qs, _, kw) in modes.items():
        cfg = SearchConfig(top_k=TOP_K, chunk_q=16, impl="ref", **kw)
        want = mut.search_codes(mut.encode_queries(qs[pick]), cfg)
        if not same(tuple(t[pick] for t in out[name]), want):
            raise AssertionError(f"{name}: 16-query recheck failed")
    log(f"recheck: 16 queries of each mode bit-exact against the plain "
        f"versions over {store.n_segments} segments")
    if profile:
        for name in ("count", "scored_f32"):
            kw = modes[name][2]
            profile_window(f"mutable {name} chunk ({store.n_segments} "
                           f"segments)",
                           lambda: mut.search(queries[:CHUNK_Q], top_k=TOP_K,
                                              chunk_q=CHUNK_Q, **kw), top=12)

    # 5. compact, search again
    before = store.n_segments
    rep, t_c = timed(lambda: mut.compact(CompactionPolicy(
        target_rows=1_048_576, max_dead_fraction=0.05)))
    rates["compact_ms"] = 1e3 * t_c
    log(f"compact: {rep}; segments {before} -> {store.n_segments} in "
        f"{1e3 * t_c:.3f} ms")
    if rep["rows_dropped"] != N_DELETE + N_UPSERT:
        raise AssertionError(f"compaction dropped {rep['rows_dropped']}")
    out2 = search_all(mut, "compacted")
    for name, (qs, _, kw) in modes.items():
        changed = int(((out2[name][0] != out[name][0]).any(1)
                       | (out2[name][1] != out[name][1]).any(1)).sum())
        if not kw.get("scored") and changed:
            raise AssertionError(f"compacted {name}: {changed} queries "
                                 f"changed")
        log(f"compacted {name}: {changed}/{qs.shape[0]} queries changed")
    check_fresh(mut, out2, "compacted")

    # 6. snapshot, restore, search again
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    snap = tempfile.mkdtemp(prefix="snapshot-", dir=os.path.join(ROOT, "build"))
    try:
        path, t_s = timed(lambda: mut.save(snap, 1))
        n_bytes = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        restored, t_r = timed(lambda: MutableAnnEngine.restore(crp, snap))
    finally:
        shutil.rmtree(snap)
    rates["save_mb_s"] = n_bytes / t_s / 1e6
    rates["restore_mb_s"] = n_bytes / t_r / 1e6
    log(f"snapshot: {n_bytes} bytes saved in {t_s:.3f} s = "
        f"{n_bytes / t_s / 1e6:.1f} MB/s, restored in {t_r:.3f} s = "
        f"{n_bytes / t_r / 1e6:.1f} MB/s")
    if {**restored.store.stats(), "generation": 0} != \
            {**store.stats(), "generation": 0} or \
            restored.store.next_id != store.next_id:
        raise AssertionError("restored store differs")
    out3 = search_all(restored, "restored")
    for name in modes:
        if not same(out3[name], out2[name]):
            raise AssertionError(f"restored {name} differs from before the "
                                 f"snapshot")
    log("restored: every mode bit-exact against the compacted engine")
    require_launched(counts, "mutable")
    log(f"launch counts on the mutable path: {json.dumps(counts)}")
    return counts, rates


def url_rows(rng, n: int):
    """n CSR rows of the URL corpus's shape: URL_NNZ distinct columns
    drawn uniformly from [0, URL_D) (sorted in the row) and standard
    normal values scaled by 1/sqrt(URL_NNZ), so that a row has about unit
    norm and its projections about unit variance, the scale the 2-bit
    scheme's w = 0.75 is chosen for -> (cols int32 [n, URL_NNZ], vals
    float32 [n, URL_NNZ])."""
    import numpy as np
    cols = rng.integers(0, URL_D, (n, URL_NNZ), dtype=np.int32)
    cols.sort(axis=1)
    dup = (np.diff(cols, axis=1) == 0).any(axis=1)
    while dup.any():
        fresh = rng.integers(0, URL_D, (int(dup.sum()), URL_NNZ),
                             dtype=np.int32)
        fresh.sort(axis=1)
        cols[dup] = fresh
        dup = (np.diff(cols, axis=1) == 0).any(axis=1)
    return cols, rng.standard_normal((n, URL_NNZ), dtype=np.float32) * \
        np.float32(1 / math.sqrt(URL_NNZ))


def url_chunk(c: int):
    """Chunk c of the URL corpus (rows c * URL_CHUNK onwards), made on the
    host from its own seed, so that any chunk can be made alone."""
    import numpy as np
    n = min(URL_CHUNK, URL_ROWS - c * URL_CHUNK)
    return url_rows(np.random.default_rng([URL_SEED, c]), n)


def as_csr(cols, vals):
    """Rows of URL_NNZ entries each -> ``CsrMatrix`` [n, URL_D]."""
    import numpy as np
    from repro_torch.encode import CsrMatrix
    n = cols.shape[0]
    return CsrMatrix(indptr=np.arange(n + 1, dtype=np.int64) * cols.shape[1],
                     indices=cols.reshape(-1), data=vals.reshape(-1),
                     shape=(n, URL_D))


def url_queries(src_cols, src_vals, rng):
    """Planted queries: each source row with URL_MOVED of its nonzeros
    moved to fresh columns and every value perturbed (noise a tenth of
    the values' scale), then as many random rows -> (CsrMatrix, mean
    cosine of planted to source)."""
    import numpy as np
    cols, vals = src_cols.copy(), src_vals.copy()
    for i in range(cols.shape[0]):
        pos = rng.choice(URL_NNZ, URL_MOVED, replace=False)
        fresh = rng.integers(0, URL_D, URL_MOVED)
        while np.isin(fresh, cols[i]).any() or \
                np.unique(fresh).size < URL_MOVED:
            fresh = rng.integers(0, URL_D, URL_MOVED)
        cols[i, pos] = fresh
    vals = vals + np.float32(0.1 / math.sqrt(URL_NNZ)) * rng.standard_normal(
        vals.shape, dtype=np.float32)
    cos = []
    for i in range(cols.shape[0]):
        _, a, b = np.intersect1d(cols[i], src_cols[i], return_indices=True)
        cos.append(float(vals[i, a].astype(np.float64)
                         @ src_vals[i, b].astype(np.float64))
                   / float(np.linalg.norm(vals[i]) * np.linalg.norm(src_vals[i])))
    rcols, rvals = url_rows(rng, cols.shape[0])
    return (as_csr(np.concatenate([cols, rcols]),
                   np.concatenate([vals, rvals])), float(np.mean(cos)))


def encode_kernel_phase(rows, crp, cols, vals, device) -> None:
    """The encode kernels at the URL path's shapes, on chunk 0 of the URL
    corpus: code_pack on its [262,144 x 256] projections, the draw of one
    full unit [4,096 x 256], the CSR step on one unit's bucket of the
    chunk (torch.addmm of that bucket as a sparse CSR tensor is the
    library yardstick); each bit-exact against its plain version."""
    import torch
    from repro_torch.core import packing, prng
    from repro_torch.kernels import ops, ref
    spec, ru = crp.spec, crp.cfg.r_unit
    csr = as_csr(cols, vals)
    n = csr.n
    w_words = packing.packed_width(K, spec.bits)
    z = crp.stream_encoder().project(csr)
    torch.cuda.synchronize()

    def row(name, want_eq, ms, plain_ms, lib_ms, b, shape, extra=""):
        b_ms, b_by, pipe = b
        if not want_eq:
            raise AssertionError(f"{name} differs from its plain version")
        rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe,
                          library_ms=lib_ms, shape=shape)
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"kernel {name}: {shape} bit-exact ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.5f} "
            f"({b_by}, {pipe}){extra}")

    # code_pack: one compare-and-add per code edge and a shift and an add
    # per field, about 7 int32 operations a value
    row("code_pack",
        torch.equal(ops.code_pack(z, spec, impl="kernel"),
                    ref.code_pack_ref(z, spec)),
        time_ms(lambda: ops.code_pack(z, spec, impl="kernel")),
        time_ms(lambda: ref.code_pack_ref(z, spec)), None,
        bound([("int32", 7.0 * n * K, INT32_OP_S)],
              4.0 * n * K + 4.0 * n * w_words),
        [n, K])

    # the draw: threefry's 20 rounds (add, rotate, xor) and 5 key
    # injections (3 adds) with the counter split, the xor of the two
    # words and the mantissa: 80 int32 operations an element; erfinv on
    # the log1p branch about 60 float32 operations (an FMA counts two)
    key = prng.fold_in(crp._key, 0)
    elems = float(ru) * K
    row("normal_unit",
        torch.equal(ops.normal_unit(key, ru, K, device, impl="kernel")
                    .view(torch.int32),
                    ops.normal_unit(key, ru, K, device, impl="ref")
                    .view(torch.int32)),
        time_ms(lambda: ops.normal_unit(key, ru, K, device, impl="kernel")),
        time_ms(lambda: ops.normal_unit(key, ru, K, device, impl="ref"),
                reps=3, warmup=1), None,
        bound([("int32", 80.0 * elems, INT32_OP_S),
               ("f32", 60.0 * elems, F32_FLOP_S)], 4.0 * elems),
        [ru, K])

    # the CSR step on the bucket of a middle unit
    u = crp.n_units // 2
    r = crp._block_r(u, crp.unit_width(u))
    indptr = torch.from_numpy(csr.indptr).to(device)
    indices = torch.from_numpy(csr.indices).to(device)
    data = torch.from_numpy(csr.data).to(device)
    lcol = indices.to(torch.int64) - u * ru
    sel = torch.nonzero((lcol >= 0) & (lcol < r.shape[0])).flatten()
    b_rows = torch.searchsorted(indptr, sel, right=True) - 1
    nnz_u, touched = sel.numel(), int(torch.unique(b_rows).numel())
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                      torch.cumsum(torch.bincount(b_rows, minlength=n), 0)])
    bucket = torch.sparse_csr_tensor(crow, lcol[sel], data[sel],
                                     (n, r.shape[0]), check_invariants=True)
    acc0 = z.clone()
    got = ops.csr_unit_step(acc0.clone(), indptr, indices, data, r, u * ru,
                            impl="kernel")
    want = ops.csr_unit_step(acc0.clone(), indptr, indices, data, r, u * ru,
                             impl="ref")
    lib = torch.addmm(acc0, bucket, r)
    lib_err = float((lib - want).abs().max())
    scratch = acc0.clone()
    row("csr_unit_step",
        torch.equal(got.view(torch.int32), want.view(torch.int32)),
        time_ms(lambda: ops.csr_unit_step(scratch, indptr, indices, data, r,
                                          u * ru, impl="kernel")),
        time_ms(lambda: ops.csr_unit_step(scratch, indptr, indices, data, r,
                                          u * ru, impl="ref"),
                reps=3, warmup=1),
        time_ms(lambda: torch.addmm(acc0, bucket, r)),
        # the bucket's entries (row, column, value) and R_u read once, the
        # touched rows of acc read and written; a multiply and an add a
        # (entry, column)
        bound([("f32", 2.0 * nnz_u * K, F32_FLOP_S)],
              12.0 * nnz_u + 4.0 * r.numel() + 8.0 * touched * K),
        [n, nnz_u, touched, int(r.shape[0]), K],
        f"; unit {u}: {nnz_u} entries on {touched} rows; addmm max abs "
        f"difference {lib_err:.3e}")
    rows["csr_unit_step"]["library_max_abs_diff"] = lib_err
    del z, acc0, scratch, got, want, lib, bucket
    torch.cuda.empty_cache()


def url_path(device, profile: bool = False) -> tuple:
    """Sparse ingest and search at the URL corpus's published width:
    CSR chunks -> IngestPipeline -> CodeStore -> AnnEngine -> count-ranked
    and scored search with CSR queries -> MutableAnnEngine ingest of the
    first two chunks, counted; then the gates."""
    import numpy as np
    import torch
    from repro_torch.ann import AnnEngine, BandSpec, CodeStore
    from repro_torch.core import packing, schemes
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import IngestPipeline
    from repro_torch.encode.encoder import R_CAP_ELEMS
    from repro_torch.index import MutableAnnEngine
    from repro_torch.kernels import ops
    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), URL_D)
    enc, bits = crp.stream_encoder(), crp.spec.bits
    w_words = packing.packed_width(K, bits)
    n_chunks = -(-URL_ROWS // URL_CHUNK)
    log(f"url: D={URL_D}, {crp.n_units} units (last {crp.unit_width(crp.n_units - 1)} "
        f"rows), R would be {URL_D * K} elements; {URL_ROWS} rows of "
        f"{URL_NNZ} nonzeros in {n_chunks} chunks of {URL_CHUNK}")
    rng = np.random.default_rng(URL_SEED)
    src_ids = np.sort(rng.choice(URL_ROWS, N_PLANTED, replace=False))
    src_cols = np.zeros((N_PLANTED, URL_NNZ), np.int32)
    src_vals = np.zeros((N_PLANTED, URL_NNZ), np.float32)
    pipe = IngestPipeline(enc, CodeStore(
        words=torch.zeros((0, w_words), dtype=torch.int32, device=device),
        k=K, bits=bits), chunk_rows=URL_CHUNK)
    rates, kept, chunk_s, t_gen, extra_max = {}, [], [], 0.0, 0
    ops.reset_launch_counts()
    for c in range(n_chunks):
        t0 = time.perf_counter()
        cols, vals = url_chunk(c)
        lo = c * URL_CHUNK
        at = (src_ids >= lo) & (src_ids < lo + cols.shape[0])
        src_cols[at], src_vals[at] = cols[src_ids[at] - lo], \
            vals[src_ids[at] - lo]
        csr = as_csr(cols, vals)
        if c < 2:
            kept.append(csr)
        t_gen += time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pipe.ingest(csr)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        # beyond what was allocated before and the store it appends to:
        # the chunk's CSR arrays, its accumulator and words, and 64 MB
        n = csr.n
        extra = torch.cuda.max_memory_allocated() - before - \
            pipe.store.nbytes
        budget = 8 * (n + 1) + 8 * csr.nnz + 4 * n * K + 4 * n * w_words \
            + 4 * R_CAP_ELEMS
        extra_max = max(extra_max, extra)
        if extra > budget:
            raise AssertionError(f"url chunk {c}: peak {extra} bytes beyond "
                                 f"the store, over the budget {budget}")
        if c == 0:
            log(f"url chunk 0: peak device memory {extra} bytes beyond the "
                f"store, budget {budget} (CSR {8 * (n + 1) + 8 * csr.nnz}, "
                f"accumulator {4 * n * K}, words {4 * n * w_words}, "
                f"64 MB)")
        del csr, cols, vals
    store = pipe.store
    t_ingest = sum(chunk_s)
    rates["ingest_rows_s"] = URL_ROWS / t_ingest
    chunk_ms = sorted(1e3 * x for x in chunk_s)
    log(f"url ingest: {URL_ROWS} rows in {t_ingest:.4f} s = "
        f"{URL_ROWS / t_ingest:.1f} rows/s (row generation on the host, "
        f"{t_gen:.1f} s, outside); ms a chunk: min {chunk_ms[0]:.3f} median "
        f"{statistics.median(chunk_ms):.3f} max {chunk_ms[-1]:.3f}; peak "
        f"memory beyond the store at most {extra_max} bytes; store "
        f"{store.nbytes} bytes")
    if enc._rmat is not None or store.n != URL_ROWS:
        raise AssertionError("url: R was built, or the store is short")

    queries, cos = url_queries(src_cols, src_vals, rng)
    t0 = time.perf_counter()
    engine = AnnEngine(crp, store, BandSpec(16, 4))
    tables = engine.rank_tables
    torch.cuda.synchronize()
    log(f"url engine: band hashes and rank tables in "
        f"{time.perf_counter() - t0:.3f} s; planted queries at mean cosine "
        f"{cos:.4f} to their sources")
    del tables
    first = queries.row_slice(0, CHUNK_Q)
    engine.encode_queries(first)                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.encode_queries(first)
    torch.cuda.synchronize()
    t_code = time.perf_counter() - t0
    t0 = time.perf_counter()
    for u in range(crp.n_units):
        crp._block_r(u, crp.unit_width(u))
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    rates["query_coding_ms_256"] = 1e3 * t_code
    rates["redraw_all_units_ms"] = 1e3 * t_draw
    log(f"url query coding: {1e3 * t_code:.3f} ms for {CHUNK_Q} CSR queries "
        f"({first.nnz} nonzeros); drawing all {crp.n_units} units alone "
        f"{1e3 * t_draw:.3f} ms")
    src_t = torch.from_numpy(src_ids.astype(np.int32)).to(device)
    out = {}
    for name, kw in (("count", {}), ("scored_f32", dict(scored=True))):
        engine.search(first, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = engine.search(queries, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[f"{name}_queries_s"] = N_QUERIES / dt
        ids, rho = out[name]
        hits = int((ids[:N_PLANTED, 0] == src_t).sum())
        log(f"url search {name}: {N_QUERIES} CSR queries in {dt:.4f} s = "
            f"{N_QUERIES / dt:.1f} queries/s; planted at rank 0: "
            f"{hits}/{N_PLANTED}; planted rho_hat median "
            f"{float(rho[:N_PLANTED, 0].median()):.4f}, random-query top "
            f"rho_hat median {float(rho[N_PLANTED:, 0].median()):.4f}")
        if ids.shape != (N_QUERIES, TOP_K) or \
                not bool(torch.isfinite(rho).all()):
            raise AssertionError(f"url {name}: wrong shape or non-finite rho")
        if hits != N_PLANTED:
            raise AssertionError(f"url {name}: planted at rank 0 "
                                 f"{hits}/{N_PLANTED}")
    mut = MutableAnnEngine(crp, band_spec=BandSpec(16, 4),
                           tail_rows=URL_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for csr in kept:
        mut.ingest(csr, chunk_rows=URL_CHUNK)
    torch.cuda.synchronize()
    t_mut = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"launch counts on the url path: {json.dumps(counts)}")
    require_launched(counts, "url")
    rates["mutable_ingest_rows_s"] = 2 * URL_CHUNK / t_mut
    if not torch.equal(mut.store.live_words(), store.words[:2 * URL_CHUNK]):
        raise AssertionError("url: the mutable engine's words differ from "
                             "the CodeStore's")
    log(f"url mutable ingest: {2 * URL_CHUNK} rows in {t_mut:.3f} s = "
        f"{2 * URL_CHUNK / t_mut:.1f} rows/s; live words equal the "
        f"CodeStore's first {2 * URL_CHUNK} rows")
    del mut, kept

    # 16 corpus rows (planted sources) through the plain versions, and
    # against a float64 oracle over their touched units
    ids16 = src_ids[:16]
    csr16 = as_csr(src_cols[:16], src_vals[:16])
    stored = store.words[torch.from_numpy(ids16).to(device)]
    t0 = time.perf_counter()
    if not torch.equal(enc.encode_packed(csr16, impl="ref"), stored):
        raise AssertionError("url: 16 rows differ from impl='ref'")
    log(f"url recheck: 16 rows bit-exact against impl='ref' on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    ru = crp.cfg.r_unit
    flat_c = src_cols[:16].reshape(-1).astype(np.int64)
    gathered = np.zeros((flat_c.size, K), np.float64)
    for u in np.unique(flat_c // ru).tolist():
        r = crp._block_r(u, crp.unit_width(u)).cpu().numpy()
        at = np.flatnonzero(flat_c // ru == u)
        gathered[at] = r[flat_c[at] - u * ru]
    z64 = (src_vals[:16].reshape(-1, 1).astype(np.float64) * gathered) \
        .reshape(16, URL_NNZ, K).sum(axis=1)
    z64_t = torch.from_numpy(z64)
    want = schemes.encode(z64_t, crp.spec)
    got = packing.unpack_codes(stored.cpu(), bits, K)
    edge = check_codes(got, want, z64_t, crp.spec, None,
                       "url float64 oracle")
    rates["oracle_edge_fields"] = edge
    log(f"url float64 oracle: 16 rows x {K} fields, {edge} differ, each "
        f"within {EDGE_TOL} of a bin edge")
    if profile:
        chunk1 = as_csr(*url_chunk(1))
        profile_window(f"url ingest of chunk 1 ({URL_CHUNK} rows)",
                       lambda: enc.encode_packed(chunk1), top=6)
        profile_window(f"url count-ranked search of {CHUNK_Q} CSR queries",
                       lambda: engine.search(first, top_k=TOP_K,
                                             chunk_q=CHUNK_Q), top=6)
    return counts, rates


def dense_cross_check(device) -> dict:
    """Dense rows above the cap (D = 131,072, 32 units): fused with R
    resident (cap raised), streamed at the default cap, and the same rows
    as CSR, agreeing but at bin edges."""
    import torch
    from repro_torch.core import packing
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import CsrMatrix, StreamingEncoder
    d, n = 131_072, 8192
    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), d)
    gen = torch.Generator(device=device).manual_seed(31)
    x = torch.randn((n, d), generator=gen, device=device)
    x *= torch.rand((n, d), generator=gen, device=device) < 0.01
    x /= x.norm(dim=1, keepdim=True)           # unit rows, as the main path's
    resident = StreamingEncoder(crp, r_cap_elems=1 << 25)
    streamed = crp.stream_encoder()
    t0 = time.perf_counter()
    csr = CsrMatrix.from_dense(x.cpu().numpy())
    t_csr = time.perf_counter() - t0
    fused = resident.encode_packed(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words = streamed.encode_packed(x)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    sparse = streamed.encode_packed(csr)
    z = streamed.project(x)
    base = packing.unpack_codes(words, crp.spec.bits, K)
    flips = {}
    for name, other in (("fused", fused), ("csr", sparse)):
        flips[name] = check_codes(packing.unpack_codes(other, crp.spec.bits,
                                                       K),
                                  base, z, crp.spec, None,
                                  f"dense cross-check {name}")
    if streamed._rmat is not None or resident._rmat is None:
        raise AssertionError("dense cross-check: R residency is wrong")
    log(f"dense cross-check: {n} rows, D={d} ({crp.n_units} units), "
        f"{csr.nnz} nonzeros: streamed {t_stream:.4f} s = "
        f"{n / t_stream:.1f} rows/s; fields differing from streamed: fused "
        f"{flips['fused']}, csr {flips['csr']} of {n * K}, each within "
        f"{EDGE_TOL} of a bin edge (CSR made in {t_csr:.1f} s)")
    return dict(dense_stream_rows_s=n / t_stream, fused_edge=flips["fused"],
                csr_edge=flips["csr"])


def profile_main_path(engine, queries, device) -> None:
    """``--profile``: device time by kernel for 8 ``sketch`` calls, each
    on a 65,536-row chunk made beforehand and each followed by a
    synchronisation (the window the ingest rate times), for one
    1,024-query search over the main path's store, for the same search
    scored (fused, f32 tables), and for one 256-query LSH chunk, scored,
    with the device's idle share of each window's wall time
    (torch.profiler)."""
    import torch
    crp, n = engine.sketcher, engine.n
    gen = torch.Generator(device=device).manual_seed(5)
    x = unit_rows(CHUNK, D, gen, device)

    def ingest():
        for _ in range(8):
            crp.sketch(x)
            torch.cuda.synchronize()

    def search(**kw):
        return lambda: engine.search(queries if kw.get("mode") != "lsh"
                                     else queries[:N_LSH], top_k=TOP_K,
                                     chunk_q=CHUNK_Q, **kw)

    for what, fn in (("ingest 8 chunks", ingest), ("search", search()),
                     ("scored search", search(scored=True)),
                     ("lsh scored search", search(mode="lsh", scored=True))):
        profile_window(f"{what} (N={n})", fn)


def profile_window(what: str, fn, top: int = 8) -> None:
    """Device time by kernel of one synchronised call of ``fn``, and the
    device's idle share of its wall time (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a host op's device time is that of
        # the kernels it launched, which are listed on their own
        if getattr(ev, "device_type", None) != DeviceType.CUDA or \
                ev.key == "Activity Buffer Request":   # the profiler's own
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    if not rows:
        raise AssertionError(f"profile {what}: no device kernels traced")
    busy = sum(r[0] for r in rows)
    log(f"profile {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.3f}")
    for ms, key, count in sorted(rows, reverse=True)[:top]:
        log(f"profile {what}:   {ms:9.3f} ms  x{count:<4d} {key[:90]}")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    reports = _build.build_all(verbose=True)
    log(f"build: {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    small_checks(device)
    scored_checks(device)
    masked_checks(device)
    encode_checks(device)
    log(f"phase small checks: {time.perf_counter() - t0:.1f} s")
    if "--check" in argv:
        log("check mode: stopping after the small-shape kernel checks")
        return 0

    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = crp.stream_encoder().r_matrix()
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    digest = hashlib.sha256(r.cpu().numpy().tobytes()).hexdigest()
    if digest != R_SHA256:
        raise AssertionError(f"R digest {digest} != the JAX reference's")
    log(f"R: drawn on the card in {1e3 * t_r:.3f} ms ({crp.n_units} units), "
        f"bit-identical to the JAX reference (SHA-256)")
    t0 = time.perf_counter()
    rows = kernel_phase(crp, device)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, rates, engine, queries, state = main_path(device)
    log(f"rates: {json.dumps(rates)}")
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_scored, rates_scored = scored_path(engine, state["queries"],
                                              state["src_ids"],
                                              state["sources"], device)
    log(f"scored path: {json.dumps(rates_scored)}")
    log(f"phase scored and LSH path: {time.perf_counter() - t0:.1f} s")
    if "--profile" in argv:
        profile_main_path(engine, queries, device)
    t0 = time.perf_counter()
    counts_mutable, rates_mutable = mutable_path(
        engine, state, device, profile="--profile" in argv)
    log(f"mutable path: {json.dumps(rates_mutable)}")
    log(f"phase mutable path: {time.perf_counter() - t0:.1f} s")
    del engine, queries, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    url_crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                                 seed=0), URL_D)
    encode_kernel_phase(rows, url_crp, *url_chunk(0), device)
    log(f"phase encode kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_url, rates_url = url_path(device, profile="--profile" in argv)
    log(f"url path: {json.dumps(rates_url)}")
    log(f"phase url path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rates_dense = dense_cross_check(device)
    log(f"dense cross-check: {json.dumps(rates_dense)}")
    log(f"phase dense cross-check: {time.perf_counter() - t0:.1f} s")
    path_counts = {"main": counts, "scored": counts_scored,
                   "mutable": counts_mutable, "url": counts_url}
    kernels = []
    for name, (path, src, rep) in KERNELS.items():
        row = dict(name=name, route="cuda", source=src, replaces=rep,
                   launches=path_counts[path][name])
        row.update(rows[name])
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
