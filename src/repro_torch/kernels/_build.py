"""Builds and loads the CUDA kernels of ``kernels/csrc`` on first use.

Each ``csrc/<name>.cu`` has a plain C interface (with the shared
``csrc/*.cuh`` headers) and compiles with its own
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` call (no PyTorch headers, no ``--use_fast_math``);
``build_all`` starts one such call per source, all at once. The shared
libraries go to ``build/kernels`` at the repository root, named by a hash
of their source and flags, and are loaded with ``ctypes``. Nothing here
runs at import time: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "function"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("coded_gemm", "pack_codes", "packed_topk", "packed_counts",
           "packed_lut", "fused_scored", "code_pack", "normal_unit",
           "csr_step", "packed_linear", "lut_topk", "collision")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}
_fns: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    # hashed over the code-generating flags only: ``-Xptxas -v`` changes
    # the compiler's report, not the library, so there is one per source
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> dict:
    """Compiles every source whose library is missing, one ``nvcc`` each,
    all started together. Returns {name: compiler output} for the
    sources it compiled (the ``-Xptxas -v`` register and spill report
    when ``verbose``); raises with the compiler's messages if any build
    fails."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in SOURCES:
        _libs[name] = ctypes.CDLL(str(_target(name)))
    _fns.clear()
    return logs


def function(lib: str, name: str, argtypes: list):
    """C function ``name`` of ``csrc/<lib>.cu`` (built on first use),
    returning the CUDA error code as an int."""
    fn = _fns.get((lib, name))
    if fn is None:
        if lib not in _libs:
            build_all()
        fn = getattr(_libs[lib], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib, name)] = fn
    return fn
