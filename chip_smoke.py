#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py            # full run: build, kernel checks, main path
    python3 chip_smoke.py --check    # build and the small-shape kernel checks only
    python3 chip_smoke.py --profile  # full run plus a torch.profiler breakdown

Phases, in order; any failure raises and the script exits non-zero:

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time, the
   compiler's register and spill report, and the card's name and power
   limit.
2. Kernel checks. Small ragged shapes over every scheme and bit width,
   then the main path's shapes: each kernel against its plain PyTorch
   version on the same inputs, on the card. ``pack_codes`` and
   ``packed_topk`` must be bit-exact; the two GEMM kernels may differ
   from ``torch.matmul``'s float32 sum order only in fields whose
   reference projection lies within 1e-5 of a bin edge. Each kernel is
   timed (CUDA events, median of 10) beside its plain version and its
   bound.
3. Main path at N = 4,194,304 rows, D = 1024, k = 256, 2-bit codes at
   w = 0.75: seeded Gaussian rows made on the card in 65,536-row chunks
   go through ``CodedRandomProjection.sketch`` into a ``CodeStore``;
   ``AnnEngine`` searches 1,024 queries (512 of them noisy corpus rows
   that must come back at rank 0), ``add``s a batch and searches again.
   Launch counts are reset just before and read just after; every kernel
   must have launched. 16 queries are then rechecked against the plain
   ``packed_topk_ref`` over the whole store.
4. A ``kernels`` JSON line, the card line, and as the last line
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

# SHA-256 of the JAX reference's R for SketchConfig() at D = 1024
# (repro.core.sketch.CodedRandomProjection(SketchConfig(), 1024)
#  .stream_encoder().r_matrix(), float32 bytes, row-major).
R_SHA256 = "a7a08cc49a0e89c4387cc9ac787b6f72a52d45fdb94e468ea171f3a24bd96818"

N_ROWS, D, K, CHUNK = 4_194_304, 1024, 256, 65_536
N_QUERIES, N_PLANTED, CHUNK_Q, TOP_K = 1024, 512, 256, 10
EDGE_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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

    wq = packing.pack_codes(torch.randint(0, 1 << bits, (CHUNK_Q, K),
                                          generator=gen, device=device), bits)
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
    del wdb
    torch.cuda.empty_cache()
    return rows


def main_path(device) -> tuple:
    """Ingest -> store -> engine -> search -> add -> search, counted."""
    import torch
    from repro_torch.ann import AnnEngine, BandSpec, CodeStore
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.kernels import ops, ref

    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), D)
    gen = torch.Generator(device=device).manual_seed(2014)
    per_chunk = N_PLANTED // (N_ROWS // CHUNK)
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
        x = unit_rows(CHUNK, D, gen, device)
        pick = torch.randint(0, CHUNK, (per_chunk,), generator=gen,
                             device=device)
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
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

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
    return counts, rates, engine, queries2


def profile_main_path(engine, queries, device) -> None:
    """``--profile``: device time by kernel for 8 ``sketch`` calls, each
    on a 65,536-row chunk made beforehand and each followed by a
    synchronisation (the window the ingest rate times), and for one
    1,024-query search over the main path's store, with the device's idle
    share of each window's wall time (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    crp, n = engine.sketcher, engine.n
    gen = torch.Generator(device=device).manual_seed(5)
    x = unit_rows(CHUNK, D, gen, device)

    def ingest():
        for _ in range(8):
            crp.sketch(x)
            torch.cuda.synchronize()

    for what, fn in (("ingest 8 chunks", ingest),
                     ("search", lambda: engine.search(queries, top_k=TOP_K,
                                                      chunk_q=CHUNK_Q))):
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
        log(f"profile {what} (N={n}): wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}")
        for ms, key, count in sorted(rows, reverse=True)[:8]:
            log(f"profile {what}:   {ms:9.3f} ms  x{count:<4d} {key[:90]}")


REPLACES = {
    "encode_fused": ("src/repro_torch/kernels/csrc/coded_gemm.cu",
                     "src/repro/kernels/encode_fused.py:80"),
    "coded_project": ("src/repro_torch/kernels/csrc/coded_gemm.cu",
                      "src/repro/kernels/proj_code.py:76"),
    "pack_codes": ("src/repro_torch/kernels/csrc/pack_codes.cu",
                   "src/repro/kernels/pack_codes.py:32"),
    "packed_topk": ("src/repro_torch/kernels/csrc/packed_topk.cu",
                    "src/repro/kernels/packed_collision.py:170"),
}


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

    small_checks(device)
    if "--check" in argv:
        log("check mode: stopping after the small-shape kernel checks")
        return 0

    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), D)
    digest = hashlib.sha256(crp.stream_encoder().r_matrix().cpu().numpy()
                            .tobytes()).hexdigest()
    if digest != R_SHA256:
        raise AssertionError(f"R digest {digest} != the JAX reference's")
    log("R: bit-identical to the JAX reference (SHA-256)")
    rows = kernel_phase(crp, device)
    counts, rates, engine, queries = main_path(device)
    log(f"rates: {json.dumps(rates)}")
    if "--profile" in argv:
        profile_main_path(engine, queries, device)
    kernels = []
    for name in ("encode_fused", "coded_project", "pack_codes", "packed_topk"):
        src, rep = REPLACES[name]
        row = dict(name=name, route="cuda", source=src, replaces=rep,
                   launches=counts[name])
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
