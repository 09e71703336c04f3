"""Threefry-2x32 counter-based generator, bit-compatible with ``jax.random``.

The canonical projection matrix R of ``repro`` is a pure function of the
seed: unit u is ``jax.random.normal(fold_in(PRNGKey(seed), u), shape)``.
This module rebuilds that function in integer PyTorch so the port draws
the same R without JAX. It follows JAX's default threefry2x32
implementation with ``jax_threefry_partitionable=True`` and 64-bit types
off:

* ``PRNGKey(seed)`` is the pair (0, seed mod 2^32);
* ``fold_in(key, d)`` hashes the count pair (0, d) under ``key``;
* ``random_bits`` hashes the 64-bit flat index of every element, split
  into (hi, lo) words, and XORs the two output words;
* ``uniform`` puts the top 23 bits into the mantissa of a float in
  [1, 2) and shifts it to the range; ``bernoulli`` is ``uniform < p``
  and ``rademacher`` ``2b - 1`` of it, in float32;
* ``normal`` is ``sqrt(2) * erfinv(max(lo, 2f + lo))`` with
  ``lo = nextafter(-1, 0)``;
* ``normal(..., dtype=torch.bfloat16)`` follows JAX's bf16 draw: its
  uniform takes one of 128 values from bits 1-7 of the same 32-bit bits
  (f = m/128, u = max(lo, 2f + lo) with lo = -255/256, exact in bf16),
  then erfinv in float32 rounded to bf16, times bf16(sqrt 2) rounded to
  bf16 (``bf16_normal_of_index``). Held to ``jax.random.normal(key,
  shape, bfloat16)`` bit for bit (``tests/test_torch_serve.py``).

The f32 ``erfinv`` is XLA's CPU lowering, term for term: Giles'
polynomial in ``w = -log1p(-x^2)`` with fused multiply-adds, where
``log1p`` is Cephes' rational form below sqrt(2)-1 and ``log(1+x)``
above, and ``log`` is the Cephes polynomial. A fused multiply-add is
computed in float64 and rounded once to float32. The normal draw depends
only on the 23 mantissa bits, so the agreement is checked on all 2^23
of them. ``torch.special.erfinv``, ``torch.log1p`` and the CPU's
vectorised float32 ``torch.sqrt`` each differ from XLA's on some inputs.

These are the plain versions: they run on the device of their inputs
(``device=`` for ``random_bits`` and ``normal``), the CPU tests use them,
and the sketch draws R with them on the CPU. On the card R's units come
from the CUDA kernel ``kernels/csrc/normal_unit.cu``, held bit for bit
to ``normal`` here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "threefry2x32", "random_bits", "uniform",
           "bernoulli", "rademacher", "normal", "normal_from_bits",
           "bf16_normal_of_index", "erfinv_xla", "log2_xla"]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M


def threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 (20 rounds) of count words x1, x2 (int64 tensors
    holding uint32 values, or Python ints) under key (k1, k2) -> two of
    the same holding uint32 values."""
    ks = (k1 & _M, k2 & _M, (k1 ^ k2 ^ 0x1BD11BDA) & _M)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def PRNGKey(seed: int) -> tuple:
    """Key of an integer seed, as ``jax.random.PRNGKey`` with 64-bit
    types off: (0, seed mod 2^32)."""
    return (0, int(seed) & _M)


def fold_in(key: tuple, data: int) -> tuple:
    """New key from ``key`` and a uint32 ``data``, as ``jax.random.fold_in``."""
    if not 0 <= int(data) <= _M:
        raise ValueError(f"fold_in data {data} out of bounds for uint32")
    # Python ints: one hash, no tensor ops (a sketch folds once a unit)
    return threefry2x32(key[0], key[1], 0, int(data))


def random_bits(key: tuple, shape, device=None) -> torch.Tensor:
    """uint32 bits (int64 tensor on ``device``, the CPU by default) of
    ``shape``, as ``jax.random.bits``."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], counts >> 32, counts & _M)
    return (b1 ^ b2).reshape(shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from the top 23 of uint32 ``bits`` (the mantissa
    of [1, 2) - 1)."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def _f32(v, like: torch.Tensor = None) -> torch.Tensor:
    """0-dim float32 constant, on ``like``'s device when given."""
    return torch.tensor(np.float32(v), dtype=torch.float32,
                        device=None if like is None else like.device)


def uniform(key: tuple, shape, minval: float = 0.0, maxval: float = 1.0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """float32 or bf16 in [minval, maxval), as ``jax.random.uniform``
    (bf16: f = m/128 from bits 1-7, the bounds and their span rounded to
    bf16, f * span + lo rounded once to bf16; exact for the draw's and
    the offsets' bounds)."""
    if dtype == torch.bfloat16:
        bf = torch.bfloat16
        lo = torch.tensor(minval, dtype=bf).float()
        span = (torch.tensor(maxval, dtype=bf).float() - lo).to(bf).float()
        f = ((random_bits(key, shape) >> 1) & 127).to(torch.float32) / 128
        return torch.maximum(lo, (f * span + lo).to(bf).float()).to(bf)
    if dtype != torch.float32:
        raise ValueError(f"uniform draws float32 or bfloat16, got {dtype}")
    lo, hi = _f32(minval), _f32(maxval)
    f = _unit_floats(random_bits(key, shape))
    # XLA contracts f * (hi - lo) + lo into one fused multiply-add
    return torch.maximum(lo, _fma(f, (hi - lo).expand_as(f), lo.expand_as(f)))


def bernoulli(key: tuple, p: float = 0.5, shape=()) -> torch.Tensor:
    """bool draws on the CPU, as ``jax.random.bernoulli``: a float32
    ``uniform`` below float32 ``p``."""
    return uniform(key, shape) < _f32(p)


def rademacher(key: tuple, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """+-1 draws on the CPU, as ``jax.random.rademacher``: 2b - 1 of
    ``bernoulli(key, 0.5, shape)``."""
    return (2 * bernoulli(key, 0.5, shape).to(dtype) - 1).to(dtype)


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add: exact product and sum in float64,
    one rounding to float32."""
    return (a.double() * b.double() + c.double()).float()


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log (Cephes logf, FMA-contracted)."""
    v = torch.clamp(v, min=float(np.float32(1.17549435e-38)))
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7E).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524, v)
    e = torch.where(small, e - 1.0, e)
    x = torch.where(small, m + m - 1.0, m - 1.0)
    x2 = x * x
    x3 = x2 * x
    c = [_f32(p, x).expand_as(x) for p in _LOG_P]
    y = _fma(_fma(c[0], x, c[1]), x, c[2])
    y1 = _fma(_fma(c[3], x, c[4]), x, c[5])
    y2 = _fma(_fma(c[6], x, c[7]), x, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4, x))
    x = x - x2 * _f32(0.5, x)
    x = x + y
    return x + e * _f32(0.693359375, x)


def log2_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log2: its log times float32(1/ln 2), each
    rounded to float32 (not correctly rounded near powers of two)."""
    return _log_xla(v) * _f32(1.0 / math.log(2.0), v)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: Cephes rational below sqrt(2)-1, else
    log(1 + x)."""
    def poly(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, _f32(c, x).expand_as(x))
        return p

    x2 = x * x
    small = _fma(_f32(-0.5, x).expand_as(x), x2,
                 (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    small = x + small
    large = _log_xla(x + 1.0)
    return torch.where(x.abs() < _f32(0.41421356237309504880, x), small,
                       large)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (Giles' single-precision polynomial)."""
    w = -_log1p_xla(-x * x)
    lt = w < 5.0
    # float64 sqrt rounded once is the correctly rounded float32 sqrt, as
    # XLA's is; torch's vectorised float32 sqrt on the CPU is not
    ww = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0], x), _f32(_ERFINV_GE5[0], x))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, ww, torch.where(lt, _f32(a, x), _f32(b, x)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 ``bits`` (int64 tensor) -> the standard normal float32 that
    ``jax.random.normal`` makes of them; a function of the top 23 bits."""
    lo = _f32(np.nextafter(np.float32(-1.0), np.float32(0.0)), bits)
    u = torch.maximum(lo, _unit_floats(bits) * (_f32(1.0, bits) - lo) + lo)
    return _f32(np.sqrt(2.0), bits) * erfinv_xla(u)


def bf16_normal_of_index(m: torch.Tensor) -> torch.Tensor:
    """The bf16 standard normal of JAX's bf16 draw for uniform index
    ``m`` in [0, 128) (any integer tensor): u = m/64 - 255/256 (exact in
    bf16), erfinv in float32 rounded to bf16, times bf16(sqrt 2), the
    exact float32 product rounded to bf16."""
    u = m.to(torch.float32) / 64.0 - 255.0 / 256.0
    e = erfinv_xla(u).to(torch.bfloat16).to(torch.float32)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.bfloat16,
                         device=m.device).to(torch.float32)
    return (e * sqrt2).to(torch.bfloat16)


def normal(key: tuple, shape, device=None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal draws in ``dtype`` (float32 or bf16) on ``device``
    (the CPU by default), as ``jax.random.normal``."""
    bits = random_bits(key, shape, device)
    if dtype == torch.bfloat16:
        return bf16_normal_of_index((bits >> 1) & 127)
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 or bfloat16, got {dtype}")
    return normal_from_bits(bits)
