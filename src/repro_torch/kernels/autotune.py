"""Measured launch-knob autotuning for the port's CUDA kernels.

Counterpart of ``repro/kernels/autotune.py``. The kernels take default
launch knobs; what wins depends on the card and the workload shape. This
module sweeps each kernel's *numerics-safe* knobs against timed calls and
caches the winner, keyed on::

    (backend, op, shape-bucket, dtype)

where the shape bucket rounds every dispatch dimension up to the next
power of two and the backend is ``"cuda"``, so close shapes share a
tuning and a cache entry never leaks to another backend.

Numerics invariant: ``SWEEPS`` lists only knobs that cannot change an
output bit. ``n_ranges`` (the corpus ranges S of the top-k kernels):
their partial lists merge in range order under the strictly-beats rule,
so any S gives the stable top-k. ``block_q``/``block_n`` of the count
kernels and ``threads`` of the packing kernels: integer outputs, one
writer each. Knobs that fix a sum order (``packed_linear_bwd``'s
``block_n``, a GEMM's reduction tile) are never swept, and kernels with
no such knob (the GEMMs, the LUT re-rank, the packed-linear kernels, the
R draw, the CSR step) have no entry. A stale, corrupt or wrong-bucket
cache entry can therefore change only timing.

Lookup is a host dict read (``ops`` consults it on every dispatch whose
caller passed no knob); measurement is explicit: ``tune`` times real
calls (CUDA events around each call, median of ``repeats``, after one
warm-up), and only on a CUDA device, unless forced or given an injected
``measure`` (how the tests drive it on the CPU). A candidate the wrapper
refuses before launch (a ``ValueError``) is skipped; a CUDA error
propagates.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import torch

__all__ = ["SWEEPS", "BACKEND", "shape_bucket", "AutotuneCache",
           "default_cache", "set_cache", "lookup", "record_config",
           "candidate_configs", "tune", "tune_search_ops"]

BACKEND = "cuda"

# op -> {knob: candidate values}; ONLY knobs that cannot change a bit.
# The count-ranked ops' tensor-core sweep runs two ranges a block at about
# one block an SM, so its S is about twice the blocks of a wave
# (``packed_collision.plan``); the LUT kernels hold several blocks an SM.
_RANGES = (8, 16, 32, 64)
_COUNT_RANGES = (16, 32, 64, 128, 256)
SWEEPS = {
    "pack_codes": {"threads": (128, 256, 512, 1024)},
    "code_pack": {"threads": (128, 256, 512, 1024)},
    "collision_counts": {"block_q": (32, 64, 128),
                         "block_n": (32, 64, 128)},
    "packed_collision_counts": {"block_q": (8, 16, 32, 64)},
    "packed_topk": {"n_ranges": _COUNT_RANGES},
    "packed_topk_masked": {"n_ranges": _COUNT_RANGES},
    "packed_lut_topk": {"n_ranges": _RANGES},
    "packed_lut_topk_masked": {"n_ranges": _RANGES},
    "fused_scored_topk": {"n_ranges": _COUNT_RANGES},
    "fused_scored_topk_masked": {"n_ranges": _COUNT_RANGES},
}

_ENV_PATH = "REPRO_AUTOTUNE_CACHE"


def _bucket_dim(v: int) -> int:
    """Next power of two >= v (0 stays 0) — the shape-bucket rounding."""
    v = int(v)
    return 0 if v <= 0 else 1 << (v - 1).bit_length()


def shape_bucket(**dims) -> str:
    """Canonical bucket string for a dispatch's dims: each value rounded
    up to the next power of two, keys sorted — e.g. ``n=100000, q=256``
    -> ``"n131072-q256"``."""
    return "-".join(f"{k}{_bucket_dim(v)}" for k, v in sorted(dims.items()))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _key(backend: str, op: str, bucket: str, dtype: str) -> str:
    return f"{backend}|{op}|{bucket}|{dtype}"


class AutotuneCache:
    """(backend, op, shape-bucket, dtype) -> knob dict, with JSON
    persistence. Entries whose knobs fall outside the op's sweep space
    are ignored at read time, so a cache file can only ever supply knobs
    the numerics invariant covers."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._configs: dict[str, dict] = {}
        if path and os.path.exists(path):
            self.load(path)

    def get(self, backend: str, op: str, bucket: str, dtype: str):
        """The cached config, filtered to the op's swept knobs; None on a
        miss or when nothing valid survives the filter."""
        cfg = self._configs.get(_key(backend, op, bucket, dtype))
        if not cfg:
            return None
        allowed = SWEEPS.get(op, {})
        out = {kn: int(v) for kn, v in cfg.items() if kn in allowed}
        return out or None

    def put(self, backend: str, op: str, bucket: str, dtype: str,
            config: dict):
        """Store one winning config (knobs outside the sweep space are
        refused: they would break the numerics invariant)."""
        allowed = SWEEPS.get(op, {})
        bad = set(config) - set(allowed)
        if bad:
            raise ValueError(f"non-sweepable knobs for {op}: {sorted(bad)}")
        self._configs[_key(backend, op, bucket, dtype)] = dict(config)

    def save(self, path: Optional[str] = None) -> str:
        """Write the cache as JSON (atomically); returns the path."""
        path = path or self.path
        if not path:
            raise ValueError("no path bound to this cache")
        tmp = f"{path}.tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": 1, "configs": self._configs}, f,
                      indent=2, sort_keys=True)
        os.replace(tmp, path)
        self.path = path
        return path

    def load(self, path: str) -> "AutotuneCache":
        """Merge entries from a JSON cache file into this cache."""
        with open(path) as f:
            data = json.load(f)
        self._configs.update(data.get("configs", {}))
        self.path = path
        return self

    def clear(self):
        """Drop every entry."""
        self._configs.clear()

    def __len__(self) -> int:
        return len(self._configs)


_CACHE: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    """The process-global cache; first use loads ``$REPRO_AUTOTUNE_CACHE``
    if the variable is set and the file exists."""
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache(os.environ.get(_ENV_PATH) or None)
    return _CACHE


def set_cache(cache: Optional[AutotuneCache]) -> Optional[AutotuneCache]:
    """Swap the process-global cache (None resets to the lazy default);
    returns the previous one."""
    global _CACHE
    prev = _CACHE
    _CACHE = cache
    return prev


def lookup(op: str, dtype, **dims) -> dict:
    """Tuned knobs for one dispatch, or ``{}`` (the kernel's defaults) on
    a cold cache or unknown bucket. Never measures, never raises."""
    return default_cache().get(BACKEND, op, shape_bucket(**dims),
                               _dtype_name(dtype)) or {}


def record_config(op: str, dtype, dims: dict, config: dict, *,
                  cache: Optional[AutotuneCache] = None):
    """Store ``config`` for ("cuda", op, bucket(dims), dtype)."""
    cache = cache if cache is not None else default_cache()
    cache.put(BACKEND, op, shape_bucket(**dims), _dtype_name(dtype), config)


def _default_measure(run: Callable[[dict], object], config: dict,
                     repeats: int) -> float:
    """Median seconds of ``run(config)`` after one warm-up call: between
    two CUDA events on a card, else by the host clock (``force`` on the
    CPU)."""
    run(config)
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(config)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            run(config)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def candidate_configs(op: str) -> list[dict]:
    """The sweep grid for ``op`` as a list of config dicts."""
    knobs = sorted(SWEEPS[op].items())
    grids = [{}]
    for name, values in knobs:
        grids = [dict(g, **{name: v}) for g in grids for v in values]
    return grids


def _measuring(measure, force: bool) -> bool:
    return measure is not None or force or torch.cuda.is_available()


def tune(op: str, run: Callable[[dict], object], dtype, dims: dict, *,
         measure: Optional[Callable] = None, repeats: int = 3,
         cache: Optional[AutotuneCache] = None,
         force: bool = False) -> dict:
    """Sweep ``op``'s knob grid by timing ``run(config)``, cache the winner
    under (backend, op, bucket(dims), dtype) and return it.

    The kernel's own defaults (``{}``) are timed first and win ties, so a
    sweep never records a config slower than no config; a winning ``{}``
    is cached as such (a lookup then gives the defaults). ``run``
    executes the op once with the given knobs (adapters close over real
    tensors). A candidate the wrapper refuses before launch (a
    ``ValueError``) is skipped; a CUDA error propagates. Without a CUDA
    device, ``force`` or an injected ``measure(run, config)`` this is a
    no-op returning ``{}``, safe to call at service warm-up."""
    if not _measuring(measure, force):
        return {}
    if measure is None:
        measure = lambda r, c: _default_measure(r, c, repeats)  # noqa: E731
    best, best_t = None, None
    for config in [{}] + candidate_configs(op):
        try:
            t = measure(run, config)
        except ValueError:
            continue
        if best_t is None or t < best_t:
            best, best_t = config, t
    if best is None:
        return {}
    record_config(op, dtype, dims, best, cache=cache)
    return best


def tune_search_ops(n: int, w: int, bits: int, k: int, *, q: int = 256,
                    top_k: int = 10, rerank_m: int = 256,
                    table_dtype="float32", seed: int = 0, device=None,
                    measure: Optional[Callable] = None,
                    cache: Optional[AutotuneCache] = None,
                    force: bool = False) -> dict:
    """Tune the search-family ops for one corpus shape bucket on seeded
    synthetic tensors on ``device`` (the card when there is one); returns
    {op: winning config}. The entry point ``serve.AnnService.warmup``
    calls; without a card (and neither ``measure`` nor ``force``) a
    no-op returning {}."""
    from repro_torch.kernels import ops as _ops

    if not _measuring(measure, force):
        return {}
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def bits32(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).to(dev)

    q_words, words_db = bits32(q, w), bits32(n, w)
    fp = w * (32 // bits) * (1 << bits)
    scales = None
    if str(table_dtype) == "int8":
        # the int8 path takes quantized tables and per-word power-of-two
        # scales (the fused kernel's contract)
        tables = torch.randint(-127, 128, (q, fp), generator=gen,
                               dtype=torch.int8).to(dev)
        scales = torch.full((q, w), 2.0 ** -7, dtype=torch.float32,
                            device=dev)
    else:
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            str(table_dtype)]
        tables = (torch.rand((q, fp), generator=gen) * 2 - 1).to(dev, tdt)
    valid = torch.full(((n + 31) // 32,), -1, dtype=torch.int32, device=dev)
    runs = {
        "packed_topk": (
            dict(q=q, n=n, w=w, top_k=top_k), q_words.dtype,
            lambda c: _ops.packed_topk(q_words, words_db, bits, k, top_k,
                                       impl="auto", **c)),
        "packed_topk_masked": (
            dict(q=q, n=n, w=w, top_k=top_k), q_words.dtype,
            lambda c: _ops.packed_topk_masked(q_words, words_db, valid,
                                              bits, k, top_k, impl="auto",
                                              **c)),
        "fused_scored_topk": (
            dict(q=q, n=n, w=w, t=fp, top_k=top_k), tables.dtype,
            lambda c: _ops.fused_scored_topk(q_words, tables, words_db,
                                             bits, k, rerank_m, top_k,
                                             scales=scales, impl="auto",
                                             **c)),
        "fused_scored_topk_masked": (
            dict(q=q, n=n, w=w, t=fp, top_k=top_k), tables.dtype,
            lambda c: _ops.fused_scored_topk_masked(
                q_words, tables, words_db, valid, bits, k, rerank_m, top_k,
                scales=scales, impl="auto", **c)),
    }
    if scales is None:
        runs["packed_lut_topk"] = (
            dict(q=q, n=n, w=w, t=fp, top_k=top_k), tables.dtype,
            lambda c: _ops.packed_lut_topk(tables, words_db, bits, top_k,
                                           impl="auto", **c))
    return {op: tune(op, run, dtype, dims, measure=measure, cache=cache,
                     force=force)
            for op, (dims, dtype, run) in runs.items()}
