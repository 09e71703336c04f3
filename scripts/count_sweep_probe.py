#!/usr/bin/env python3
"""Where a tile's time goes in the tensor-core count sweep
(``src/repro_torch/kernels/csrc/topk_tc.cuh``), by phase, on one card.

    python3 scripts/count_sweep_probe.py    # needs one CUDA card and nvcc

Copies ``kernels/csrc`` into ``build/count_sweep_probe``, puts ``clock64``
timers around the phases of the sweep's tile loop (each warp's clocks
summed into a device array) and builds ``packed_topk.cu`` from the copy
twice: as it is, and with every tile's staging and offers left out (the
wgmmas alone; its lists are then wrong and not checked). It runs the
count sweep alone (``packed_topk_partial_launch``, the wrappers' plan) on
seeded words: 256 queries (2-bit, k = 256) against 4,194,304 rows at
top_k 10 and at m 64, and against one 262,144-row segment at top_k 10.
For each it prints the kernel's ms (CUDA events, one launch after a
warm-up), the clocks a warp spends a tile in each phase (the load's wait
and barrier, issuing the wgmmas, draining them, the hit test and staging,
the barrier, the offers), the queries a warp offers a tile, and, for the
whole copy, that the partial lists are bit-exact against their plain
version. Timers add a few instructions a phase. Prints the card's name
and power limit and a JSON line of all of it.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import packed_collision as pc  # noqa: E402

OUT = os.path.join(ROOT, "build", "count_sweep_probe")
PHASES = ("wait", "issue", "drain", "stage", "barrier", "offers")
# (text of topk_tc.cuh, what it becomes): the timers
PATCHES = [
    ("namespace {\n\nconstexpr int TC_WG",
     "__device__ unsigned long long tc_prof[8];\nnamespace {\n\n"
     "constexpr int TC_WG"),
    ("  for (int t = 0; t < tiles; ++t) {\n    if (t + 1 < tiles)\n"
     "      load_tile(t + 1);",
     "  unsigned long long P[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  long long T0 = clock64(), T1;\n"
     "  for (int t = 0; t < tiles; ++t) {\n    T0 = clock64();\n"
     "    if (t + 1 < tiles)\n      load_tile(t + 1);"),
    ("    bar_sync(bar, 128);   // tile t landed; every warp is past tile "
     "t - 1\n",
     "    bar_sync(bar, 128);   // tile t landed; every warp is past tile "
     "t - 1\n    T1 = clock64(); P[0] += T1 - T0; T0 = T1;\n"),
    ("    wgmma_wait<0>();\n#pragma unroll\n    for (int i = 0; i < 2 * "
     "TC_KW; ++i) keep_regs<4>(a1[i]);",
     "    T1 = clock64(); P[1] += T1 - T0; T0 = T1;\n    wgmma_wait<0>();\n"
     "#pragma unroll\n    for (int i = 0; i < 2 * TC_KW; ++i) "
     "keep_regs<4>(a1[i]);"),
    ("    // acc[4j + e] is tile row lr0 + 8 (e >> 1), query 8j + 2 tig + "
     "(e & 1)\n    const int row0",
     "    T1 = clock64(); P[2] += T1 - T0; T0 = T1;\n#ifdef WGMMA_ONLY\n"
     "    if (acc[0] == 123456789) part_vals[0] = acc[1];\n    continue;\n"
     "#endif\n    // acc[4j + e] is tile row lr0 + 8 (e >> 1), query 8j + 2 "
     "tig + (e & 1)\n    const int row0"),
    ("    bar_sync(bar, 128);   // hits and counts staged\n",
     "    T1 = clock64(); P[3] += T1 - T0; T0 = T1;\n"
     "    bar_sync(bar, 128);   // hits and counts staged\n"
     "    T1 = clock64(); P[4] += T1 - T0; T0 = T1;\n"),
    ("        if (lane == 0) thr[qq] = last;\n      }\n  }\n",
     "        if (lane == 0) thr[qq] = last;\n        P[6] += 1;\n      }\n"
     "    T1 = clock64(); P[5] += T1 - T0; T0 = T1;\n  }\n"
     "  if (lane == 0)\n    for (int i = 0; i < 7; ++i) "
     "atomicAdd(&tc_prof[i], P[i]);\n"
     "  if (tid == 0) atomicAdd(&tc_prof[7], (unsigned long long)tiles);\n"),
]
READ = ('\nextern "C" int tc_prof_read(unsigned long long* out) {\n'
        '  cudaError_t e = cudaMemcpyFromSymbol(out, tc_prof, '
        'sizeof(tc_prof));\n  unsigned long long z[8] = {0};\n'
        '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tc_prof, z, '
        'sizeof(z));\n  return (int)e;\n}\n')
VARIANTS = {"whole": [], "wgmma alone": ["-DWGMMA_ONLY"]}


def build() -> dict:
    """The patched copy, built once a variant (in parallel) -> {variant:
    library}."""
    src = os.path.join(OUT, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    path = os.path.join(src, "topk_tc.cuh")
    text = open(path).read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"topk_tc.cuh no longer has: {old[:60]!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    with open(os.path.join(src, "packed_topk.cu"), "a") as f:
        f.write(READ)
    procs = {}
    for name, flags in VARIANTS.items():
        lib = os.path.join(OUT, f"lib{len(procs)}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib,
             os.path.join(src, "packed_topk.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("count_sweep_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    bits, k = 2, 256
    wq = ref.pack_codes_ref(torch.randint(0, 4, (256, k), generator=gen,
                                          device=dev), bits)
    wdb = torch.randint(-2 ** 31, 2 ** 31, (4_194_304, wq.shape[1]),
                        generator=gen, device=dev,
                        dtype=torch.int64).to(torch.int32)
    P, I = ctypes.c_void_p, ctypes.c_int
    buf = (ctypes.c_ulonglong * 8)()
    results = []
    for variant, lib in libs.items():
        launch = lib.packed_topk_partial_launch
        launch.argtypes = [P, P, P, P, P] + [I] * 10 + [P]
        read = lib.tc_prof_read
        read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        for case, n, top_k in (("4,194,304 rows, top_k 10", 4_194_304, 10),
                               ("4,194,304 rows, m 64", 4_194_304, 64),
                               ("262,144-row segment, top_k 10", 262_144,
                                10)):
            db = wdb[:n]
            p = pc.plan(256, n, wq.shape[1], bits, top_k, device=dev)
            pv = torch.empty((p["n_ranges"], 256, top_k), dtype=torch.int32,
                             device=dev)
            pi = torch.empty_like(pv)
            args = [wq.data_ptr(), db.data_ptr(), None, pv.data_ptr(),
                    pi.data_ptr(), 256, n, wq.shape[1], bits, k, top_k,
                    p["n_ranges"], p["block_q"], p["smem"],
                    int(p["lists_in_smem"]),
                    torch.cuda.current_stream(dev).cuda_stream]
            if launch(*args):
                raise RuntimeError(f"launch failed: {variant} {case}")
            torch.cuda.synchronize()
            read(buf)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch(*args)
            b.record()
            b.synchronize()
            if read(buf):
                raise RuntimeError("reading the timers failed")
            v = list(buf)
            warp_tiles = 4 * v[7]
            row = dict(variant=variant, case=case, ms=a.elapsed_time(b),
                       plan=p, tiles_a_range=v[7] / (p["grid"][0]
                                                    * p["n_ranges"]),
                       clocks_a_warp_tile={ph: v[i] / warp_tiles
                                           for i, ph in enumerate(PHASES)},
                       offered_queries_a_warp_tile=v[6] / warp_tiles)
            if variant == "whole":
                row["bit_exact"] = bool(ref.packed_topk_partial_ref(
                    wq, db, None, bits, k, top_k, p["n_ranges"])[0].equal(pv)
                    and ref.packed_topk_partial_ref(
                        wq, db, None, bits, k, top_k,
                        p["n_ranges"])[1].equal(pi))
                if not row["bit_exact"]:
                    raise AssertionError(f"{case}: partial lists differ")
            results.append(row)
            clocks = " ".join(f"{ph} {c:.0f}" for ph, c in
                              row["clocks_a_warp_tile"].items())
            print(f"{variant}, {case}: {row['ms']:.4f} ms, QB "
                  f"{p['block_q']}, S {p['n_ranges']}; clocks a warp a tile: "
                  f"{clocks}; queries offered a warp a tile "
                  f"{row['offered_queries_a_warp_tile']:.2f}", flush=True)
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
