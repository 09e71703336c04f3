#!/usr/bin/env python3
"""Times the coded-projection GEMM kernels under other tiles and rings.

    python3 scripts/gemm_tile_sweep.py        # needs one CUDA card and nvcc

Builds a copy of ``src/repro_torch/kernels/csrc/coded_gemm.cu`` for each
configuration below, with its ``CP_*`` (coded_project) and ``EF_*``
(encode_fused) constants replaced: consumer warpgroups of 64 rows, tile
width, ring stages. All builds run at once, into ``build/gemm_sweep``. Each configuration then runs at the main path's
shapes: encode_fused at [65,536 x 1,024] @ [1,024 x 256] (2-bit, w =
0.75) and coded_project at M = 64, 256 and 1,024 on unit rows and an
N(0, 1) R split by ``ops.split_r``. Its output must be bit-identical to
the default configuration's (a row's sum order is fixed by D alone),
and every launch's to the first.
Prints the card's name and power limit, one line per configuration and
shape with its median time (CUDA events, each launch queued behind a
spin kernel, median of 20), and a JSON line of all times.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# name -> constants replaced; "default" is the source as it stands
CONFIGS = {
    "default": {},
    "cp 1x32 s8": dict(CP_WG=1, CP_BN=32, CP_STAGES=8),
    "cp 1x32 s12": dict(CP_WG=1, CP_BN=32, CP_STAGES=12),
    "cp 1x16 s4": dict(CP_WG=1, CP_BN=16, CP_STAGES=4),
    "cp 1x16 s8": dict(CP_WG=1, CP_BN=16, CP_STAGES=8),
    "cp 1x64 s4": dict(CP_WG=1, CP_BN=64, CP_STAGES=4),
    "cp 2x32 s4": dict(CP_WG=2, CP_BN=32, CP_STAGES=4),
    "ef 2x128 s3": dict(EF_WG=2, EF_BN=128, EF_STAGES=3),
    "ef 1x128 s5": dict(EF_WG=1, EF_BN=128, EF_STAGES=5),
    "ef 2x64 s6": dict(EF_WG=2, EF_BN=64, EF_STAGES=6),
    "ef 1x64 s8": dict(EF_WG=1, EF_BN=64, EF_STAGES=8),
}
D, K, M_FUSED, M_PROJECT = 1024, 256, 65_536, (64, 256, 1024)
REPS = 20


def variant(src: str, consts: dict) -> str:
    """The source with each ``NAME = value`` of ``consts`` replaced."""
    for name, value in consts.items():
        src, n = re.subn(rf"\b{name} = \d+", f"{name} = {value}", src)
        if n != 1:
            raise ValueError(f"constant {name} not found once in the source")
    return src


def build(out_dir: str) -> dict:
    """One nvcc per configuration, all at once -> {name: launch fn}."""
    from repro_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    src = (_build.CSRC / "coded_gemm.cu").read_text()
    procs = {}
    for i, (name, consts) in enumerate(CONFIGS.items()):
        cu = os.path.join(out_dir, f"coded_gemm_{i}.cu")
        lib = os.path.join(out_dir, f"libcoded_gemm_{i}.so")
        with open(cu, "w") as f:
            f.write(variant(src, consts))
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(lib).coded_gemm_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, P, P, I, I, I, I, ctypes.c_float, I, I, P]
        fn.restype = I
        libs[name] = fn
    return libs


def main() -> int:
    import torch
    from chip_smoke import card_line, time_ms
    from repro_torch.core.packing import packed_width
    from repro_torch.core.schemes import CodeSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.proj_code import SCHEME_IDS
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    libs = build(os.path.join(ROOT, "build", "gemm_sweep"))
    print(f"built {len(libs)} configurations in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"card: {card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    spec = CodeSpec("2bit", 0.75)
    r = torch.randn((D, K), generator=gen, device="cuda")
    r_split = ops.split_r(r)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for m in (M_FUSED,) + M_PROJECT:
        x = torch.randn((m, D), generator=gen, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        bits = spec.bits if m == M_FUSED else 0
        out = torch.empty((m, packed_width(K, spec.bits) if bits else K),
                          dtype=torch.int32, device="cuda")
        cases.append((m, bits, x, out))
    times, want = {}, {}
    for name, fn in libs.items():
        for m, bits, x, out in cases:
            what = f"{'encode_fused' if bits else 'coded_project'} M={m}"

            def call():
                err = fn(x.data_ptr(), r_split.data_ptr(), 2, D, None,
                         out.data_ptr(), m, D, K, SCHEME_IDS[spec.scheme],
                         spec.w, spec.n_bins_side, bits, stream)
                if err:
                    raise RuntimeError(f"{name} {what}: error {err}")
            call()
            torch.cuda.synchronize()
            first = out.clone()
            if name == "default":
                want[what] = first
            elif not torch.equal(first, want[what]):
                raise AssertionError(f"{name} {what}: differs from default")
            ms = time_ms(call, reps=REPS)
            if not torch.equal(out, first):   # the timed launches too
                raise AssertionError(f"{name} {what}: launches differ")
            times.setdefault(name, {})[what] = ms
            print(f"{name:14s} {what:20s} ms={ms:.4f} bit-identical",
                  flush=True)
    print(json.dumps({"gemm_tile_sweep": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
