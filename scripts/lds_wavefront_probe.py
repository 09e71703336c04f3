#!/usr/bin/env python3
"""How many shared-memory wavefronts one warp load costs on this card,
by its width (LDS.32, LDS.64, LDS.128) and how many distinct entries its
32 lanes read.

    python3 scripts/lds_wavefront_probe.py    # needs one CUDA card and nvcc

Builds ``scripts/lds_probe.cu`` into ``build/lds_probe`` and times its
kernel (CUDA events, median of 5) for each (width, distinct) pattern
below; the entries are contiguous. LDS.32 with 32 distinct words (128
bytes, one per bank) is one wavefront: each pattern's wavefronts are its
time over that one's. The LUT top-k's fields kernel (``csrc/lut_topk.cu``)
reads P distinct 16-byte entries a load, P = 2, 4 or 16 at 1, 2 or 4
bits. Prints the card's name and power limit, one line a pattern, and a
JSON line of all of it.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "scripts", "lds_probe.cu")
OUT = os.path.join(ROOT, "build", "lds_probe", "liblds_probe.so")
PATTERNS = ((4, 32), (4, 1), (4, 4), (8, 1), (8, 2), (8, 4), (8, 16),
            (16, 1), (16, 2), (16, 4), (16, 8), (16, 32))
ITERS, WAVES = 4096, 8


def main() -> int:
    if not torch.cuda.is_available():
        print("lds_wavefront_probe: no CUDA device", file=sys.stderr)
        return 1
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", OUT, SRC], check=True)
    lib = ctypes.CDLL(OUT)
    fn = lib.lds_probe_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    props = torch.cuda.get_device_properties(0)
    blocks = props.multi_processor_count * WAVES
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for width, distinct in PATTERNS:
        times = []
        for rep in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = fn(width, distinct, ITERS, blocks, out.data_ptr(), stream)
            b.record()
            b.synchronize()
            if err:
                raise RuntimeError(f"lds_probe launch failed: CUDA error "
                                   f"{err}")
            if rep:
                times.append(a.elapsed_time(b))
        ms[(width, distinct)] = statistics.median(times)
    print(card)
    per_sm = blocks * 8 * ITERS / props.multi_processor_count  # warp loads
    one = ms[(4, 32)]
    result = []
    for width, distinct in PATTERNS:
        t = ms[(width, distinct)]
        result.append(dict(width=width, distinct=distinct, ms=t,
                           wavefronts=t / one,
                           ns_per_warp_load_per_sm=1e6 * t / per_sm))
        print(f"LDS.{8 * width}, {distinct:2d} distinct entries "
              f"({width * distinct} B): {t:.4f} ms, {t / one:.2f} "
              f"wavefronts, {1e6 * t / per_sm:.3f} ns a warp load an SM")
    print(json.dumps({"card": card, "lds": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
